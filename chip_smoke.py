#!/usr/bin/env python3
"""Drive the PyTorch port's sampling, training, ops, evaluation, serving,
import, data-parallel, native-loader, 1024² and chunked-dispatch paths, its
submodel zoo and its face-swap pairs once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from pggan_tpu_torch/csrc with nvcc, one
     process per source, all at once (timed);
  3. each forward kernel against its plain PyTorch version on the card, f32
     and bf16, at the sampling path's shapes and at shapes that reach every
     branch of the row kernels (the vector branch at several lane and
     vector counts; the generic branch for rows that are not a multiple of
     16 bytes, rows over the cap, and [B, C] views whose pointer is not
     16-byte aligned), with the branch each input took and the output's
     strides;
  4. the sampling slice at the full width of configs.yaml: write a scale-6
     (256×256) G checkpoint in the JAX package's npz format (numpy-seeded
     weights, alpha 0.5), run `pggan_tpu_torch.demo` for 32 images at batch
     16, check the JPEGs and the kernel launch counts (2 pixel_norm and 13
     lrelu_pixel_norm per forward);
  5. the full-width forward with the kernels against the same forward with
     the plain versions, and a small generator on the card against the CPU;
  6. times on the card: sampling img/s; each kernel's call time (eager
     calls) and device time (calls captured in a CUDA graph and replayed)
     against its plain version, pixel_norm also against F.rms_norm; where
     the host time of a small pixel_norm call goes (checks, allocation,
     launch, glue); the fused upscale+conv against conv(upscale2d(x)); peak
     memory;
  7. the backward kernel of lrelu_pixel_norm and the minibatch-stddev kernel
     against their plain versions, f32 and bf16, at the train path's shapes
     and at shapes that reach every branch of both (the backward's vector
     branch at C = 64-512 and the generic one for ragged rows, rows over the
     cap and misaligned views of x and of g; the minibatch-stddev vector
     branch and the generic one for rows that are not a multiple of 16
     bytes or a misaligned view), with the branch each input took and two
     calls of the minibatch-stddev kernel compared bit for bit; and the
     first and second derivatives of the minibatch-stddev autograd rule
     against autograd of its plain version;
  8. the training slice through its entry point: a JAX-format G+D checkpoint
     (params and a fresh Adam state) at scale 6, full width, resumed by
     `pggan_tpu_torch.train.main` for a few r1 steps at batch 16 in bf16 on
     synthetic data, a checkpoint cycle included; checks the loss lines, that
     G and D moved, the checkpoints' JAX key sets and the launches per step
     (4 pixel_norm, 26 lrelu_pixel_norm, 13 backward, 3 minibatch-stddev),
     and that every backward call of the run took the vector branch;
  9. one f32 step (TF32 off, cuDNN's deterministic algorithms, D's
     learning rate 0) at full width with the kernels against the same step
     with the plain versions, from the same state, on several draws of the
     batch and latents, r1 and wgangp: losses and Adam's first moments (=
     the gradients, β1 = 0); the kernel path run twice agrees bit for bit;
     on each r1 draw, the leaky-ReLU inputs that fall on the other side of 0
     on the other path, counted by call; and a probe of the draw whose G
     gradient differs most: the step with D's (and G's) leaky ReLUs forced
     to the kernel path's side of 0, and the gradient of the 128² toRGB
     weight split into its pixels' terms beside the flips near them;
 10. times on the card: the R1 step, the step without R1 and the wgangp
     step, each in bf16, f32 with TF32 off and f32 with TF32 on; peak
     memory; the train path's
     kernels against their plain versions (call and device time; the
     backward at the three largest epilogue shapes beside its bound, the
     minibatch-stddev call beside pixel_norm's at the same shape);
 11. the StyleGAN2-ops path (`pggan_tpu_torch.ops`): the bias_lrelu_gain
     kernel against its plain version (f32 and bf16, the epilogue shapes and
     ragged ones, with and without a bias) and its rule's first and second
     derivatives against autograd of the plain version; bias_act and
     filtered_lrelu at the two top blocks' shapes through the ops entry
     points with the launch counts (1 per leaky-ReLU call, none otherwise)
     and kernel path vs plain path; a small case of every ops function on
     the card against the CPU, grid_sample's second derivatives included;
     times of the kernel, its plain version and filtered_lrelu;
 12. training from a folder of images through `pggan_tpu_torch.train.main`:
     48 JPEGs of 320x320 in two subdirectories, phase 8's checkpoint resumed
     at full width, batch 16, bf16, with the threaded data pipeline (8
     workers, 2 batches of prefetch): every batch reaching the step is uint8
     [16,256,256,3] on the card, the launches per step are phase 8's, the
     sample grids, metrics.jsonl and the config snapshot are checked; a
     SIGTERM sent from a step hook checkpoints at the next step boundary and
     returns cleanly, and the resume's first batch equals, byte for byte,
     the uninterrupted run's at that step; the rates: the pipeline alone
     (8 worker threads and 1), the trainer's imgs_per_sec on folder and on
     synthetic data, and whether the host keeps up with the bf16 step;
 13. validation, FID and KID on the training path through
     `pggan_tpu_torch.train.main`: phase 8's checkpoint resumed at full width
     with configs/config_demo256_fid.yaml's evaluation keys (bf16 r1 steps,
     G EMA, 2 validation batches, 256 FID samples, the fixed-seed
     InceptionV3), from 96 JPEGs, validation and FID on cycles cut to a few
     steps; checks the val_* and fid/kid/kid_std records, the launches per
     validation batch and per FID fake batch, the fakes' dtype, FID of the
     reals against themselves against that of the fakes, and
     `pggan_tpu_torch.eval_metrics` on the last checkpoint against the
     in-run metrics; the extractors on the card against the CPU; the times
     of validation(), of the parts of an FID/KID call and of the steps with
     the hooks on and off; whether the recipe's `device_data_cache: auto`
     turned the device data cache on;
 14. the device data cache on the training path through
     `pggan_tpu_torch.train.main` (`device_data_cache: true`, phase 12's 48
     JPEGs, phase 8's checkpoint, bf16, batch 16): the cache line, every
     batch uint8 [16,256,256,3] on the card, the launches per step phase
     8's, the unaugmented batches equal to the host pipeline's byte for
     byte and the augmented ones to the same draws assembled on the CPU
     within one step of 255; SIGTERM and the resume's first batch; the
     assembly's rates and the trainer's imgs_per_sec over lazy-R1/16 spans
     with the cache, the host pipeline and synthetic data;
 15. the serving artifact: `pggan_tpu_torch.demo --export` on phase 4's
     checkpoint, the artifact loaded in a fresh process and sampled at
     batches 1, 3 and 16 against the eager G (f32, TF32 off), 2 and 13
     launches per forward, a bf16 artifact against the eager bf16 G, an
     artifact exported on the CPU served on the card, and
     tools/bench_serving_torch.py in direct and artifact modes;
 16. a reference (PyTorch) checkpoint at full width: reference-format
     `G_*.pt` / `D_*.pt` at scale 6 (numpy-seeded weights under the
     reference's key names, one G block without PixelNorm's Sequential
     indices, the schedule scalars at alpha 0.5, an `args` dict) imported by
     `python -m pggan_tpu_torch.import_ckpt` (timed), sampled by
     `pggan_tpu_torch.demo` (2 and 13 launches a forward), and the imported
     G (f32, TF32 off) against a functional forward of the state_dict
     within 1e-5 of the largest output;
 17. the data-parallel path on the one card, resuming phase 16's import:
     `torchrun --nproc_per_node 1 -m pggan_tpu_torch.train --use_mGPU` (the
     NCCL group line, the loss lines, rank 0's checkpoints), the spawn
     route (`--use_mGPU` without torchrun), the same run in this process
     with phase 8's launches per step; the data-parallel f32 step against
     the single-process step bit for bit (TF32 off, deterministic cuDNN);
     the bf16 steps with and without the gradient all-reduce and the
     all-reduce's own time;
 18. the native image loader, grain and configs/config_1024.yaml: the
     compiler, libjpeg's and libpng's headers and grain on this machine;
     the loader built from pggan_tpu_torch/native/loader.cpp (timed); the
     datasets' backend, native against PIL draws at 256² and 1024² and
     cached, stored and uncached draws against each other, on phase 12's
     folder and 48 JPEGs of 1024² and 1280²; the pipeline alone, native
     and PIL, 8 and 1 workers, at 256² (RAM cache) and 1024² (resized
     store), and the trainer's imgs_per_sec over lazy R1/16 at 256² with
     the native loader, PIL and synthetic data; `pggan_tpu_torch.train.main`
     on config_1024.yaml's keys at full width from the high-resolution
     folder (native loader, resized store) for a few bf16 r1 steps at
     scale 7 (512², batch 32) and 8 (1024², batch 16) with the batches, the
     launches, the losses and the checkpoints checked; their step times
     and peak memory with and without R1; lrelu_pixel_norm's forward and
     backward at [16,1024,1024,16] and [32,512,512,32] against their plain
     versions with their times and bounds; a torch.profiler capture of the
     scale-8 step (idle share, top kernels, layout copies); and, where
     grain imports, a few steps with data_backend_impl: grain;
 19. chunked dispatch (`train/graphs.py`): at full width, scale 6, f32 with
     TF32 off and cuDNN's deterministic algorithms, a steps_per_dispatch
     window of 4 replays of the captured step and a lazy-R1 window of 4 (the
     lead's graph, 3 replays of the tail's) against the same windows' eager
     steps from the same state and batches, bit for bit in the weights,
     G_ema, Adam's state, the latent generator's state and the metrics (the
     lazy window again in bf16, its difference printed), with the launches
     a replay; `pggan_tpu_torch.train.main --steps_per_dispatch auto` at
     scale 4 (64²) in bf16: the windows of 8 between the loss lines, the
     launches (wrapper calls at capture times replays), finite losses, and a
     run cut by SIGTERM and resumed equal to the uninterrupted one bit for
     bit; tools/bench_e2e_torch.py at 16², 64² and 256²: every step one a
     call against windows of 8 graph replays, lazy R1/16 eager against graph
     replays (the trainer's img/s, the steps' device time, the share outside
     them, the idle share); config_1024.yaml at 1024² in windows of 2 (the
     capture's seconds, the peak memory); and phase 17's group of one
     through lazy windows with NCCL's all-reduce captured and
     `check_replication_consistency`.
 20. the submodel zoo at its published sizes, batch 16, numpy-seeded weights:
     ArcFace IR-SE-50 (112²), BiSeNet (19 classes, 512²), e4e (18 styles,
     256²), ReconNet (224²) into the face model at the BFM 2009 front face's
     size (35,709 vertices, numpy-seeded bases, a grid triangulation, 68
     landmarks),
     LPIPS (AlexNet, pairs at 256²), PatchGAN (n_layers 3, width 64),
     multiscale (3 scales × n_layers 6) and StarGAN-v2 (img_size 256)
     discriminators at 256², and the latent MLP (code_dim 512): each
     state_dict (the reference's keys for the five reference networks, and
     BiSeNet's ResNet-18 alone) loaded with strict=True on the card and
     through the port's converter on the CPU; the card's f32 forward (TF32
     off) against the CPU's (the whole batch, or the first two samples and
     the last for BiSeNet, e4e and ReconNet); the input gradients through
     LPIPS and through id_loss on ArcFace embeddings, card against CPU, in
     float64 and in f32; items/s in f32, TF32 and bf16 autocast (the median
     of five windows and their spread) with TFLOP/s and peak memory; the
     idle share of a
     bf16 forward under torch.profiler; and no kernel of this repo launched;
 21. face-swap pairs into the zoo: 16 (Xs, Xt, same_person) pairs at 256²
     drawn by `pggan_tpu_torch.data.PairedFaceDataset` (same_prob 0.2) from
     phase 12's folder of 48 JPEGs, its two subdirectories as two roots,
     equal to a second draw with the same seeds (through 1 and through 8
     threads); the pairs on the card as uint8, normalised there, into phase
     20's ArcFace (resized to 112² by `models.zoo.interpolate2d`, then
     `losses.gan.id_loss(IRSE(Xs), IRSE(Xt))`) and LPIPS (each pair at
     256²) in f32 with TF32 off, against the same modules' CPU forwards of
     the same pairs; the host's pairs/s, ArcFace items/s, LPIPS pairs/s and
     peak memory; and no kernel of this repo launched.

The second-to-last lines are a JSON object describing the kernels and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}, count the
cards the run used. Exits non-zero without a CUDA device, and imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import io
import itertools
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, SCALE, ALPHA = 16, 6, 0.5
RES = 4 * 2 ** SCALE
DEVICE = "cuda"
# f32: kernel and plain differ only in the order of the channel sum and in
# rsqrtf's last bits. bf16: additionally one bf16 rounding of the output,
# which can land one bf16 ulp (2^-8 relative) apart.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
# Whole forward, f32 with TF32 off: kernel-level differences of ~1e-7
# relative, carried through 13 convolutions, on outputs of magnitude ~1-5.
FORWARD_ATOL = 1e-4
# The backward kernel sums two products per row where the plain version
# sums one each, and the result can cancel to ~0: f32 atol 1e-5 on values of
# order 1. bf16 as the forward (one bf16 rounding of the output).
BWD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
# Minibatch-stddev: f32 output either way, sums in another order.
MB_TOL = dict(rtol=1e-5, atol=1e-6)
FORWARD_KERNELS = ("pixel_norm", "lrelu_pixel_norm")
TRAIN_STEPS = 4            # steps of the training slice (phase 8)
# Kernel launches of one bf16 r1 step at scale 6 (phases 8 and 12).
STEP_LAUNCHES = {"pixel_norm": 4, "lrelu_pixel_norm": 26, "lrelu_pixel_norm_bwd": 13,
                 "minibatch_stddev_stat": 3, "bias_lrelu_gain": 0}
# Phase 12: the folder of images, the steps of each run, the step after
# which SIGTERM arrives (counted from the run's first), and the batches the
# pipeline alone is timed over after warming its decode cache.
FOLDER_IMAGES, FOLDER_SIDE = 48, 320
FOLDER_STEPS, SIGTERM_AFTER = 8, 2
PIPELINE_BATCHES = 24
# Phase 13: validation, FID and KID on the training path with the
# evaluation keys of EVAL_CONFIG (the repo's full-width 256² recipe), from
# a folder of EVAL_IMAGES JPEGs: the 30 % valid split (29 images) holds more
# than one FID batch of 16. The run resumes phase 8's checkpoint for at
# least EVAL_STEPS steps and ends one step after an FID step, so its final
# checkpoint holds the state that FID step measured; validation every
# EVAL_TEST_CYCLE steps and FID every EVAL_FID_CYCLE (cut from 4000 each).
EVAL_CONFIG = os.path.join("configs", "config_demo256_fid.yaml")
EVAL_KEYS = ("compute_dtype", "loss_mode", "g_ema_decay", "use_validation", "val_batches",
             "fid_samples", "fid_extractor", "fid_weights", "device_data_cache",
             "device_cache_mb")
EVAL_IMAGES, EVAL_STEPS, EVAL_TEST_CYCLE, EVAL_FID_CYCLE = 96, 6, 2, 3
# Phase 14: the device data cache on the training path, on phase 12's folder
# (48 JPEGs: 9.4 MB at 256²). CACHE_STEPS steps for the unaugmented
# runs; FOLDER_STEPS and SIGTERM_AFTER for the augmented one and its cut;
# the lazy-R1 runs take r1_interval LAZY_R1 with a loss line every LAZY_R1
# steps, and their imgs_per_sec is read over LAZY_WINDOWS such spans; the
# assembly alone is timed over ASSEMBLE_BATCHES batches. Augmented batches
# on the card against the same assembly on the CPU: the same f32 ops, the
# contrast's mean summed in another order, so at most one step of 255
# (ASSEMBLE_LSB) and rarely that (ASSEMBLE_MEAN). Against the PIL path's
# batches the distance is printed, not bounded: the PIL path rounds to
# uint8 between ops and turns the hue through 8-bit HSV, and the JAX
# package's cache reads the same distance from its PIL path.
CACHE_STEPS, LAZY_R1, LAZY_WINDOWS, ASSEMBLE_BATCHES = 4, 16, 2, 50
# A cycle no run reaches, and not the default 10000 (a key equal to its
# default does not count as set, and a resume then takes the checkpoint's).
NEVER = 100003
ASSEMBLE_LSB, ASSEMBLE_MEAN = 1, 0.01
# Phase 15: the serving artifact of phase 4's checkpoint sampled at these
# batches in a fresh process; f32 with TF32 off, the artifact against the
# eager G (the same kernels and cuDNN calls: equal up to the convolution
# algorithm cuDNN picks); bf16 within one bf16 step of the larger value.
SERVE_BATCHES, SERVE_ATOL = (1, 3, BATCH), 1e-5
# Kernel launches of one forward of G at scale 6 (as phase 4's).
SERVE_LAUNCHES = {"pixel_norm": 2, "lrelu_pixel_norm": 13}
# Launches of one validation batch (G's forward, D on reals and on fakes,
# no backward) and of one FID fake batch (G's forward).
VAL_LAUNCHES = {"pixel_norm": 2, "lrelu_pixel_norm": 13, "lrelu_pixel_norm_bwd": 0,
                "minibatch_stddev_stat": 2, "bias_lrelu_gain": 0}
FAKE_LAUNCHES = dict(VAL_LAUNCHES, minibatch_stddev_stat=0)
# Phase 16: a reference (PyTorch) checkpoint at scale 6: G's blocks whose
# second conv sits at Sequential index 2 (no PixelNorm modules between the
# convs) rather than 3; the imported G against a functional forward of the
# state_dict, f32 with TF32 off: max |diff| over the largest output.
REF_PLAIN_BLOCKS, IMPORT_RTOL = (2,), 1e-5
# Phase 17: steps of the data-parallel runs (a checkpoint every 2), of the
# spawn route, and of the f32 comparison with the single-process step.
DP_STEPS, SPAWN_STEPS, DP_COMPARE_STEPS = 4, 2, 2
# The extractors on the card against the CPU, f32 with TF32 off, the same
# weights: cuDNN and the CPU sum in other orders through InceptionV3's 94
# convolutions (the JAX package's torch-mirror test allows rtol = atol = 2e-3): max
# |diff| over the largest feature. The offline entry point recomputes the
# in-run metrics from the checkpoint of the same state in the same process:
# the same features up to the convolution algorithms cuDNN picks.
INCEPTION_CARD_TOL, RANDOM_CONV_CARD_TOL = 1e-3, 1e-4
EVAL_METRICS_FID_RTOL, EVAL_METRICS_KID_ATOL = 1e-4, 1e-5
# Phase 18: the native image loader, grain and configs/config_1024.yaml at
# scales 7 (512², batch 32) and 8 (1024², batch 16). HIRES_IMAGES JPEGs, half
# of each side in HIRES_SIDES (CelebA-HQ's published 1024², and a real
# downscale). Native against PIL draws of the same images: the resize within
# LOADER_RESIZE_LSB (their triangle filters sum in other orders); the jitter
# on average within LOADER_AUG_MEAN, and more than LOADER_AUG_LSB apart on at
# most LOADER_AUG_TAIL of the values (PIL rounds to uint8 between ops and
# turns the hue through 8-bit HSV, the native loader stays in float: on these
# noisy images a CPU run of the same code read 1.47-1.51 on average, the
# largest 15-18 steps, above 8 on 0.007-0.011 % of the values). A
# cached or stored draw against an uncached one: the cache rounds to uint8
# between the resize and the jitter, at most half a step, which three
# factors of up to 1.2 scale to under 1 step, so within TIER_LSB after the
# final rounding. LOADER_DRAWS images a comparison; the pipeline alone over
# HIRES_RATE_BATCHES batches a resolution; HIRES_STEPS steps a training run;
# the lrelu_pixel_norm kernels at HIRES_KERNEL_SHAPES, device time from
# HIRES_DEVICE_CALLS calls a graph (each output is up to 1 GB).
CONFIG_1024 = os.path.join("configs", "config_1024.yaml")
HIRES_IMAGES, HIRES_SIDES, HIRES_SCALES = 48, (1024, 1280), (7, 8)
LOADER_RESIZE_LSB, LOADER_AUG_LSB, LOADER_AUG_TAIL, LOADER_AUG_MEAN = 1, 8, 1e-3, 2.5
TIER_LSB = 2
LOADER_DRAWS = 12
HIRES_RATE_BATCHES = {256: 12, 512: 6, 1024: 4}
HIRES_STEPS, GRAIN_STEPS = 3, 3
HIRES_KERNEL_SHAPES = [(16, 1024, 1024, 16), (32, 512, 512, 32)]
HIRES_DEVICE_CALLS = 5
# Phase 19: chunked dispatch. Windows of CHUNK_K steps replayed from the
# captured steps against the same windows' eager steps, from the same state
# and batches, with the weight average at CHUNK_EMA; the trainer at scale
# CHUNK_SCALE (64²) with steps_per_dispatch auto (8 there) over
# CHUNK_RUN_STEPS steps with a loss line every CHUNK_LOSS_CYCLE, cut by a
# SIGTERM after CHUNK_CUT and resumed; the trainer's rates at RATE_SCALES
# over RATE_STEPS timed steps (windows of RATE_WINDOW; lazy R1/RATE_LAZY);
# config_1024.yaml at scale 8 in windows of HIRES_CHUNK.
CHUNK_K, CHUNK_EMA = 4, 0.999
CHUNK_SCALE, CHUNK_LOSS_CYCLE, CHUNK_RUN_STEPS, CHUNK_CUT = 4, 10, 40, 20
RATE_SCALES, RATE_WINDOW, RATE_LAZY = (2, 4, 6), 8, 16
RATE_STEPS = {2: 32, 4: 32, 6: 16}
HIRES_CHUNK = 2
# Phase 20: the submodel zoo at its published sizes (ZOO_SIDES), ZOO_BATCH a
# batch, numpy-seeded weights. The card's f32 forward (TF32 off) against the
# CPU's, max |diff| over the largest |value|, on the whole batch for the
# networks of ZOO_CPU_WHOLE and on the samples ZOO_CPU_ROWS (the first two
# and the last) for the others: cuDNN and the CPU sum in other orders
# through up to ~100 convolutions (the port against JAX on the CPU: within
# 1e-5 at the tests' sizes). Input gradients against the CPU's float64
# ones: the card's float64 within ZOO_GRAD_RTOL of the largest value
# (id_loss rounds the embeddings to f32 in both), its f32 within
# ZOO_GRAD32_RTOL of each sample's norm (a ReLU or max-pool flip under
# rounding moved up to 1.7e-3 on an H100; a wrong gradient moves ~1). The
# face model at the size of the BFM 2009 front face the reference builds
# (`transferBFM09`): 35,709 vertices, 68 landmarks, a seeded grid of
# BFM_GRID_COLS columns for its triangles. Rates: after 3 warm-up forwards, ZOO_WINDOWS windows of CUDA
# events, each of at least ZOO_WINDOW_MS of forwards; the median and the
# spread of the windows.
ZOO_SIDES = {"arcface": 112, "bisenet": 512, "e4e": 256, "reconnet": 224, "lpips": 256,
             "patch": 256}
ZOO_BATCH = 16
ZOO_CPU_ROWS = (0, 1, ZOO_BATCH - 1)
ZOO_CPU_WHOLE = ("arcface", "lpips", "patchgan", "multiscale", "stargan", "latent")
ZOO_WINDOWS, ZOO_WINDOW_MS = 5, 100.0
ZOO_CARD_RTOL, ZOO_GRAD_RTOL, ZOO_GRAD32_RTOL = 1e-4, 1e-6, 1e-2
BFM_VERTICES, BFM_LANDMARKS, BFM_GRID_COLS = 35709, 68, 189
# Phase 21: PAIRS pairs at PAIR_SIDE² with same_prob PAIR_SAME_PROB, the
# sample i drawn from RandomState(PAIR_SEED + i); the host's rate over
# PAIR_RATE_PAIRS pairs with each of PAIR_THREADS; the card against the CPU
# within ZOO_CARD_RTOL of the largest value, as phase 20.
PAIRS, PAIR_SIDE, PAIR_SAME_PROB, PAIR_SEED = 16, 256, 0.2, 2100
PAIR_RATE_PAIRS, PAIR_THREADS = 64, (1, 8)
# cuDNN and PyTorch kernels that only move data between layouts (the
# work hires_pack removed on the TPU): matched in the profile's kernel names.
LAYOUT_COPY_NAMES = ("copy", "transpose", "nchwToNhwc", "nhwcToNchw")

# One f32 step (TF32 off), kernel path vs plain path (phase 9): bounds on
# the relative loss difference and on the gradient difference relative to
# the largest gradient of each network. cuDNN's default backward algorithms
# do not sum in a fixed order (the kernel path run twice differed by up to
# 2.6e-4 of the largest gradient on an H100), so the step runs with cuDNN's
# deterministic algorithms and the kernel path twice must agree bit for
# bit; kernel vs plain then measures the kernels alone. D's learning rate
# is 0 in this step, so G's gradient is taken against the D both paths
# start from: D's first Adam step moves each entry by about lr·sign(g), and
# a sign that rounding flips carried a difference of 9.0e-3 of G's largest
# gradient on one draw, with this package and with the one before it alike.
# Each draw of the batch and latents is a CUDA generator's (seed, Philox
# offset); (0, 5508) is that draw. With D held, an H100 gave losses up to
# 2.1e-7, D up to 5.0e-4 and G up to 2.2e-4, but 1.3e-3 on (0, 5508).
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-5, 2e-3
STEP_DRAWS = ((0, 0), (1, 0), (2, 0), (0, 5508))
# Phase 9 also holds the wgangp recipe's step (configs/config_demo64_wgangp.yaml's
# loss: BCE, the gradient penalty on eps-interpolates and drift) on one draw,
# to the same bounds. On every r1 draw it counts the leaky-ReLU inputs that
# fall on the other side of 0 on the other path (a G epilogue's input, G's
# format layer's, D's layers'): inputs within rounding of 0 that take the
# other slope.
WGANGP_DRAWS = ((0, 0),)
# Phase 9's probe of the draw (0, 5508), where G's gradient differs about 6×
# more than on the other draws, beside a usual draw: the f32 step on the
# kernel path, the plain path, the plain path with D's leaky ReLUs forced to
# the kernel path's side of 0 at every input, and with G's forced too; and
# the gradient of torgb/PROBE_TORGB's weight (the 128² toRGB, where the
# largest difference sits) split into its pixels' terms, with the flips
# within PROBE_RADIUS pixels (at 128²) of the pixels that carry it.
PROBE_DRAWS = ((0, 5508), (0, 0))
PROBE_TORGB, PROBE_RADIUS, PROBE_TOP = SCALE - 1, 4, 8
# Phase 11: the ragged shapes of phase 3, bias_lrelu_gain's (slope, gain)
# pairs, the filtered_lrelu shapes (the two top blocks of the 256² model at
# batch 16) and bias_act's activations.
RAGGED = [(2, 3, 3, 16), (2, 4, 4, 513), (2, 4, 4, 96)]
# Phase 3 also holds every branch of the forward row kernels: the vector
# branch at each row width (C = 16 and 96 with a lane count under 32 and
# part-filled lanes; 1024 f32 and 2048 bf16 at the cap of 8 vectors a lane;
# C = 4 f32, one vector a row) and the generic one (C = 513, bf16 C = 4, C
# = 2048 f32 over the cap, and MISALIGNED [B, C] views).
BRANCH_SHAPES = RAGGED + [(2, 3, 3, 4), (2, 2, 2, 1024), (2, 2, 2, 2048)]
MISALIGNED = [(BATCH, 512), (BATCH, 64)]
# Phase 7: the backward at the path's shapes and at RAGGED, C = 1024 and
# 2048 (the cap in f32 and bf16; 2048 f32 is over it), and at MISALIGNED
# views of x and of g; the minibatch-stddev kernel at the path's groups,
# a fused 2B step's 8 groups, sg = N = 6, sg 2, F = 45 (not a multiple of
# 16 bytes) at sg 4 and 6 (the kernel's sg = 4 case and its any-sg loop)
# and a misaligned view (NHWC shape, sg, one element into its storage).
BWD_BRANCH_SHAPES = RAGGED + [(2, 2, 2, 1024), (2, 2, 2, 2048)]
MB_CASES = [((BATCH, 4, 4, 512), 4, False), ((2 * BATCH, 4, 4, 512), 4, False),
            ((6, 4, 4, 512), 6, False), ((2, 4, 4, 512), 2, False),
            ((4, 3, 3, 5), 4, False), ((6, 3, 3, 5), 6, False),
            ((BATCH, 4, 4, 512), 4, True)]
# Phase 10: the backward's timed shapes, the three largest epilogues.
BWD_TIMED = [(BATCH, 64, 64, 256), (BATCH, 128, 128, 128), (BATCH, 256, 256, 64)]
BIAS_PARAMS = ((0.2, math.sqrt(2.0)), (0.1, 1.0))
OPS_SHAPES = [(BATCH, 128, 128, 128), (BATCH, 256, 256, 64)]
ACTIVATIONS = ("linear", "relu", "lrelu", "tanh", "sigmoid", "elu", "selu", "softplus",
               "swish")
# Call times of inputs of at most SMALL_NUMEL elements (host-bound
# launches) are means over SMALL_ITERS calls, not 20.
SMALL_NUMEL, SMALL_ITERS = BATCH * 4 * 4 * 512, 200
# H100 SXM datasheet peaks: HBM bytes/s, f32 FLOP/s off
# the tensor cores, dense TF32 and bf16 FLOP/s on them.
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12
TF32_FLOPS, BF16_FLOPS = 495e12, 989e12
# Untimed replays before `device_ms` times its graph (see there).
DEVICE_WARM_S = 0.1


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def nhwc(shape, dtype, gen):
    """A random [B, C, H, W] channels_last (or [B, C]) tensor from an NHWC shape."""
    x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    return x.permute(0, 3, 1, 2) if x.ndim == 4 else x


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def abba_ms(*fns, iters: int = 20):
    """Times in turns, each function in order and then in reverse order
    (plain, kernel, kernel, plain); the mean of each function's pair."""
    first = [time_ms(fn, iters) for fn in fns]
    second = [time_ms(fn, iters) for fn in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def device_ms(fn, kernels=None, name=None, calls: int = 20, replays: int = 5,
              groups: int = 3) -> float:
    """The device time of one call: `calls` calls captured in one CUDA graph
    (after warm-up on a side stream), `replays` replays of it timed with
    CUDA events, so no host work sits between the launches; the best of
    `groups` such timings, after untimed replays for DEVICE_WARM_S (one at
    a time, so the time is the card's): right after phase 10's full-width
    step timing, the first ~30-60 ms of the f32 [16,64,64,256] backward's
    replays ran 15 % slow at unchanged clocks (tools/probe_device_ms.py),
    which 3 untimed replays did not cover. A
    wrapper launches on the current stream, which is the capture stream
    while capturing, so its launches are captured. Checks that the launch
    count of `name` moved once per captured call and not during the
    replays, and that the replayed graph wrote what the call computes
    eagerly: the last captured output is set to NaN (an integer output to
    the bitwise complement of the eager result) before the replays, so a
    launch made outside the graph would leave it so."""
    want = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kernels.launches[name] if name else 0
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    if name:
        check(kernels.launches[name] - before == calls,
              f"{name}: {kernels.launches[name] - before} launches in a capture of {calls} calls")
    if out.is_floating_point():
        out.fill_(float("nan"))
    else:                               # every element differs from the eager result
        out.copy_(torch.bitwise_not(want))
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < DEVICE_WARM_S:
        graph.replay()
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / (replays * calls))
    if name:
        check(kernels.launches[name] - before == calls, f"{name}: launched during a replay")
    check(torch.equal(out, want), f"{name or 'call'}: the replayed graph's output differs "
                                  f"from the eager call's")
    return best


@contextlib.contextmanager
def plain_epilogues(kernels):
    """Route the generator's pixel_norm / lrelu_pixel_norm to the plain
    PyTorch versions, for comparison and timing only."""
    with mock.patch.object(kernels, "pixel_norm", kernels.pixel_norm_plain), \
            mock.patch.object(kernels, "lrelu_pixel_norm",
                              kernels.lrelu_pixel_norm_plain):
        yield


@contextlib.contextmanager
def plain_kernels(kernels):
    """Route G's and D's kernel calls to the plain PyTorch versions, which
    autograd differentiates itself (no kernel forward or backward)."""
    with plain_epilogues(kernels), mock.patch.object(
            kernels, "minibatch_stddev_stat", kernels.minibatch_stddev_stat_plain):
        yield


def epilogue_shapes(depths, scale, batch):
    """NHWC input of every lrelu_pixel_norm call of one forward, in order."""
    shapes = [(batch, 4, 4, depths[0])]
    for i in range(1, scale + 1):
        shapes += [(batch, 4 * 2 ** i, 4 * 2 ** i, depths[i])] * 2
    return shapes


def numpy_generator_arrays(seed, latent_dim, depths, scale, output_dim=3):
    """G weights in the JAX package's checkpoint layout, drawn with numpy:
    N(0, 1) weights, U(±1/sqrt(fan_in)) biases, He constants."""
    rng = np.random.default_rng(seed)

    def layer(prefix, w_shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return {f"{prefix}/w": rng.standard_normal(w_shape, dtype=np.float32),
                f"{prefix}/b": rng.uniform(-bound, bound, w_shape[-1]).astype(np.float32),
                f"{prefix}/scale": np.asarray(np.sqrt(2.0 / fan_in), np.float32)}

    def conv(prefix, k, cin, cout):
        return layer(prefix, (k, k, cin, cout), k * k * cin)

    d0 = depths[0]
    arrays = layer("format", (latent_dim, 16 * d0), latent_dim)
    arrays.update(conv("first_conv", 3, d0, d0))
    arrays.update(conv("torgb/0", 1, d0, output_dim))
    for i in range(1, scale + 1):
        arrays.update(conv(f"blocks/{i - 1}/conv0", 3, depths[i - 1], depths[i]))
        arrays.update(conv(f"blocks/{i - 1}/conv1", 3, depths[i], depths[i]))
        arrays.update(conv(f"torgb/{i}", 1, depths[i], output_dim))
    return arrays


def numpy_discriminator_arrays(seed, depths, scale, input_dim=3):
    """D weights in the JAX package's checkpoint layout, drawn as
    `numpy_generator_arrays` draws G's."""
    rng = np.random.default_rng(seed)

    def conv(prefix, k, cin, cout):           # k = 0: a linear layer
        fan_in = k * k * cin if k else cin
        bound = 1.0 / np.sqrt(fan_in)
        shape = (k, k, cin, cout) if k else (cin, cout)
        return {f"{prefix}/w": rng.standard_normal(shape, dtype=np.float32),
                f"{prefix}/b": rng.uniform(-bound, bound, cout).astype(np.float32),
                f"{prefix}/scale": np.asarray(np.sqrt(2.0 / fan_in), np.float32)}

    d0 = depths[0]
    arrays = conv("fromrgb/0", 1, input_dim, d0)
    arrays.update(conv("last_conv", 3, d0 + 1, d0))
    arrays.update(conv("last_linear", 0, 16 * d0, d0))
    arrays.update(conv("decision", 0, d0, 1))
    for i in range(1, scale + 1):
        arrays.update(conv(f"fromrgb/{i}", 1, input_dim, depths[i]))
        arrays.update(conv(f"blocks/{i - 1}/conv0", 3, depths[i], depths[i]))
        arrays.update(conv(f"blocks/{i - 1}/conv1", 3, depths[i], depths[i - 1]))
    return arrays


def fresh_adam_arrays(params):
    """optax's Adam state before its first step, flattened as in a JAX
    checkpoint."""
    opt = {"0/count": np.asarray(0, np.int32)}
    for moment in ("mu", "nu"):
        opt.update({f"0/{moment}/{k}": np.zeros_like(v) for k, v in params.items()})
    return opt


def bound_ms(nbytes, flops):
    """The least time the card could take: bytes over HBM bandwidth or f32
    operations over the f32 peak, whichever is larger. Returns (ms, by)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return smi.splitlines()[0]


def misaligned_rows(shape, dtype, gen):
    """A random contiguous [B, C] view that starts one element into its
    storage, so its pointer is not 16-byte aligned."""
    flat = torch.randn(shape[0] * shape[1] + 1, generator=gen, device=DEVICE).to(dtype)
    return flat[1:].view(shape)


def check_row_plan(label, plan, cols, elem_bytes, shifted):
    """A row kernel's branch: the generic one for misaligned views, rows
    that are not a multiple of 16 bytes and rows over 4096 bytes; the
    vector one at the widths of configs.yaml."""
    row_bytes = cols * elem_bytes
    if shifted or row_bytes % 16 or row_bytes > 4096:
        check(plan == (0, 0), f"{label}: expected the generic branch, got {plan}")
    elif cols in (64, 128, 256, 512):
        check(plan != (0, 0), f"{label}: expected the vector branch")


def check_kernels(kernels, shapes, gen):
    """Phase 3: every forward kernel against its plain version, f32 and bf16,
    at `shapes` (NHWC or [B, C]) and at MISALIGNED [B, C] views one element
    into their storage; each input's branch as the C side picks it. Checks
    that the widths of configs.yaml take the vector branch and the
    misaligned views, C = 513 and bf16 rows under 16 bytes the generic one.
    Returns {kernel: {dtype: max |diff|}}."""
    max_err = {name: {dt: 0.0 for dt in TOL} for name in FORWARD_KERNELS}
    branches = {}
    cases = [(shape, False) for shape in shapes] + [(s, True) for s in MISALIGNED]
    with torch.no_grad():
        for (shape, shifted), (dt, tol) in itertools.product(cases, TOL.items()):
            x = misaligned_rows(shape, dt, gen) if shifted else nhwc(shape, dt, gen)
            plan = kernels.row_kernel_plan(x)
            label = f"{list(shape)}{' +1' if shifted else ''} {str(dt)[6:]}"
            branches[label] = plan
            check_row_plan(label, plan, shape[-1], x.element_size(), shifted)
            for name in FORWARD_KERNELS:
                got = getattr(kernels, name)(x)
                want = getattr(kernels, name + "_plain")(x)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got, want, **tol, msg=lambda m: f"{name} {label}: {m}")
                check(got.stride() == want.stride(), f"{name} {label}: strides "
                      f"{got.stride()}, plain {want.stride()}")
                err = float((got.float() - want.float()).abs().max())
                max_err[name][dt] = max(max_err[name][dt], err)
    print("[3 kernels] branches (lanes a row, 16-byte vectors a lane; (0, 0) = generic): "
          + ", ".join(f"{k} {v}" for k, v in branches.items()))
    return max_err


def run_demo(demo, kernels, cfg, depths, tmp):
    """Phase 4: a JAX-format checkpoint at full width, sampled through the
    demo's entry point. Returns the kernel launches of that run."""
    from pggan_tpu_torch.utils import checkpoint as ckpt_lib

    arrays = numpy_generator_arrays(1234, int(cfg.latent_dim), depths, SCALE)
    ckpt_lib.save_checkpoint(tmp, "smoke", "G", 0, params=arrays, meta={
        "args": cfg.to_dict(), "schedule": {"scale_index": SCALE, "alpha": ALPHA}})
    launches, files, demo_s = sample_demo(demo, kernels, tmp, "smoke")
    forwards = len(files) // BATCH
    print(f"[4 slice] demo wrote {len(files)} JPEGs of 256x256 from a JAX-format "
          f"scale-{SCALE} checkpoint in {demo_s:.2f} s (checkpoint load, "
          f"{forwards} forwards, JPEG writes); launches {launches} = "
          f"{forwards} forwards x (2, 13)")
    return launches


def sample_demo(demo, kernels, save_root, run_id):
    """`pggan_tpu_torch.demo` on a run: 2 × BATCH images at batch BATCH,
    the JPEGs and the launches (2 pixel_norm and 13 lrelu_pixel_norm a
    forward) checked. Returns (launches, files, seconds)."""
    from PIL import Image

    out_dir = os.path.join(save_root, f"samples_{run_id}")
    n_samples = 2 * BATCH
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = demo.main(["--ckpt_id", run_id, "--save_root", save_root, "--device", DEVICE,
                    "--n_samples", str(n_samples), "--batch_size", str(BATCH),
                    "--output_dir", out_dir])
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"demo returned {rc}")
    forwards = n_samples // BATCH
    want = {"pixel_norm": 2 * forwards, "lrelu_pixel_norm": 13 * forwards,
            "lrelu_pixel_norm_bwd": 0, "minibatch_stddev_stat": 0, "bias_lrelu_gain": 0}
    check(launches == want, f"launches {launches}, expected {want}")
    files = sorted(os.listdir(out_dir))
    check(len(files) == n_samples, f"{len(files)} files written")
    for name in files:
        with Image.open(os.path.join(out_dir, name)) as img:
            check(img.size == (256, 256) and img.mode == "RGB",
                  f"{name}: {img.size} {img.mode}")
    return launches, files, demo_s


def check_forward(kernels, generator, z, alpha):
    """Phase 5: kernel path against plain path at full width, and a small
    generator on the card against the same one on the CPU."""
    from pggan_tpu_torch.models.generator import Generator

    with torch.no_grad():
        out_kernel = generator(z, alpha)
        with plain_epilogues(kernels):
            out_plain = generator(z, alpha)
    check(out_kernel.shape == (BATCH, 256, 256, 3), f"shape {out_kernel.shape}")
    check(bool(torch.isfinite(out_kernel).all()), "non-finite output")
    forward_err = float((out_kernel - out_plain).abs().max())
    torch.testing.assert_close(out_kernel, out_plain, rtol=0.0, atol=FORWARD_ATOL)
    print(f"[5 forward] 256x256 batch {BATCH} f32: kernel path vs plain path max "
          f"|diff| {forward_err:.3g} (atol {FORWARD_ATOL}); output range "
          f"[{float(out_kernel.min()):.3f}, {float(out_kernel.max()):.3f}]")

    small = Generator(latent_dim=64, depths=[64, 64, 32, 16], scale=3, seed=7,
                      init_bias_to_zero=False)
    z_small = torch.randn((4, 64), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want_cpu = small(z_small, 0.5)
        got_card = small.to("cuda")(z_small.to("cuda"), 0.5).cpu()
    small_err = float((got_card - want_cpu).abs().max())
    torch.testing.assert_close(got_card, want_cpu, rtol=0.0, atol=FORWARD_ATOL)
    print(f"[5 forward] small G (depths [64,64,32,16], 32x32): card vs CPU max "
          f"|diff| {small_err:.3g} (atol {FORWARD_ATOL})")


def time_sampling(kernels, generator, z, alpha, card):
    """Phase 6a: one forward at batch 16, kernel path and plain path."""
    for dt in (torch.float32, torch.bfloat16):
        def kernel_fwd(dt=dt):
            generator(z, alpha, compute_dtype=dt)

        def plain_fwd(dt=dt):
            with plain_epilogues(kernels):
                generator(z, alpha, compute_dtype=dt)
        plain_ms, kernel_ms = abba_ms(plain_fwd, kernel_fwd, iters=10)
        torch.cuda.reset_peak_memory_stats()
        kernel_fwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"[6 times] sampling 256x256 batch {BATCH} {str(dt)[6:]}: kernel "
              f"path {kernel_ms:.3f} ms/batch = {BATCH / kernel_ms * 1e3:.1f} img/s; "
              f"plain path {plain_ms:.3f} ms = {BATCH / plain_ms * 1e3:.1f} img/s; "
              f"peak memory {peak:.0f} MiB ({card})")
    torch.backends.cudnn.allow_tf32 = True
    tf32_ms = time_ms(lambda: generator(z, alpha), iters=10)
    torch.backends.cudnn.allow_tf32 = False
    print(f"[6 times] sampling f32 with cuDNN TF32 on (PyTorch's default): "
          f"kernel path {tf32_ms:.3f} ms = {BATCH / tf32_ms * 1e3:.1f} img/s ({card})")


def time_kernels(kernels, path_shapes, gen, card):
    """Phase 6b: each kernel against its plain version at pixel_norm's two
    path shapes and the three largest epilogue shapes: the call time (eager
    calls, host work included) and the device time (`device_ms`); pixel_norm
    also against F.rms_norm, the one PyTorch call that computes its
    function, in the same turns. Returns {(kernel, shape, dtype): (call ms,
    device ms, plain ms)} and {(shape, dtype): (F.rms_norm call ms, device
    ms)} at pixel_norm's 4-D shapes."""
    import torch.nn.functional as F

    times, rms = {}, {}
    timed = [("pixel_norm", (BATCH, 512)), ("pixel_norm", (BATCH, 4, 4, 512))] + [
        (name, shape) for name in FORWARD_KERNELS
        for shape in sorted(set(path_shapes), key=np.prod)[-3:]]
    for name, shape in timed:
        for dt in (torch.float32, torch.bfloat16):
            x = nhwc(shape, dt, gen)
            fns = [lambda: getattr(kernels, name + "_plain")(x),
                   lambda: getattr(kernels, name)(x)]
            with_rms = name == "pixel_norm" and len(shape) == 4
            if with_rms:
                # the same NHWC rows as a contiguous [..., C] tensor
                x_rows = x.permute(0, 2, 3, 1)
                fns.append(lambda: F.rms_norm(x_rows, [shape[-1]], eps=1e-8))
            # host-bound calls: more of them, so a hiccup of the host's clock
            # weighs less
            iters = SMALL_ITERS if x.numel() <= SMALL_NUMEL else 20
            plain_ms, kernel_ms, *rms_turns = abba_ms(*fns, iters=iters)
            kernel_dev = device_ms(fns[1], kernels, name)
            gbps = 2 * x.numel() * x.element_size() / (kernel_dev * 1e-3) / 1e9
            times[(name, shape, dt)] = (kernel_ms, kernel_dev, plain_ms)
            line = (f"[6 times] {name} {list(shape)} {str(dt)[6:]}: kernel call "
                    f"{kernel_ms:.4f} ms, device {kernel_dev:.4f} ms ({gbps:.0f} GB/s of "
                    f"one read + one write); plain call {plain_ms:.4f} ms")
            if with_rms:
                rms_call, rms_dev = rms[(shape, dt)] = (rms_turns[0], device_ms(fns[2]))
                err = float((fns[2]().permute(0, 3, 1, 2).float() - fns[1]().float())
                            .abs().max())
                line += (f"; F.rms_norm call {rms_call:.4f} ms, device {rms_dev:.4f} ms "
                         f"(max |diff| to the kernel {err:.3g})")
            print(f"{line} ({card})")
    return times, rms


def host_us(fn, calls: int = 2000, loops: int = 5) -> float:
    """Host time of one call in µs by the host clock: the best of `loops`
    loops of `calls` calls, each loop then waited for on the card. For a
    call whose host work outlasts its kernel, this is the call time without
    the card's timing in the way."""
    best = float("inf")
    for _ in range(loops + 1):                   # the first loop warms up
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def time_launch_path(kernels, gen, card):
    """Phase 6c: where the host time of one pixel_norm call at [16,4,4,512]
    f32 goes (a launch-bound call: its kernel takes ~2 µs), beside
    F.rms_norm's: the whole call, and of it the checks (`kernel_rows`), the
    output's allocation and the launch (ctypes into the C entry point and
    its cudaLaunchKernel); the rest is Python glue. The launch is timed by
    calling the C entry point directly, outside the wrapper, so it is not
    counted."""
    import torch.nn.functional as F
    from pggan_tpu_torch.ops import _build

    x = nhwc((BATCH, 4, 4, 512), torch.float32, gen)
    x_rows, y = x.permute(0, 2, 3, 1), torch.empty_like(x)
    rows, cols = kernels.kernel_rows(x)
    entry = _build.load_library().pggan_pixel_norm_fwd
    stream = torch.cuda.current_stream().cuda_stream
    parts = {"whole call": lambda: kernels.pixel_norm(x),
             "checks": lambda: kernels.kernel_rows(x),
             "allocation": lambda: torch.empty_like(x),
             "launch": lambda: entry(x.data_ptr(), y.data_ptr(), rows, cols, 0, 1e-8,
                                     stream)}
    us = {label: host_us(fn) for label, fn in parts.items()}
    rms_us = host_us(lambda: F.rms_norm(x_rows, [512], eps=1e-8))
    glue = us["whole call"] - us["checks"] - us["allocation"] - us["launch"]
    print(f"[6 host] pixel_norm [16, 4, 4, 512] float32, host µs a call (best of 5 loops of "
          f"2000 calls): {us['whole call']:.2f} = checks {us['checks']:.2f} + allocation "
          f"{us['allocation']:.2f} + launch (ctypes, C entry point, cudaLaunchKernel) "
          f"{us['launch']:.2f} + Python glue {glue:.2f}; F.rms_norm {rms_us:.2f} ({card})")


def time_block_heads(generator, depths, gen, card):
    """Phase 6d: each block's conv0, the dilated form against
    conv(upscale2d(x)). Tolerance f32 1e-3 (TF32 off; sums of up to 4608
    products in another order); bf16 0.25 (the merged taps are rounded to
    bf16 once, the plain form rounds each tap, on outputs up to ~10)."""
    from pggan_tpu_torch.ops.basic import upscale2d
    from pggan_tpu_torch.ops.equalized import equalized_conv2d
    from pggan_tpu_torch.ops.fused_scale import upscale_conv3x3_dilated

    for i in range(1, SCALE + 1):
        res = 4 * 2 ** (i - 1)
        conv0 = generator.blocks[i - 1].conv0
        w, b, s = conv0.weight, conv0.bias, conv0.scale
        for dt in (torch.float32, torch.bfloat16):
            x = nhwc((BATCH, res, res, depths[i - 1]), dt, gen)

            def fused():
                return upscale_conv3x3_dilated(x, w, b, s, compute_dtype=dt)

            def plain():
                return equalized_conv2d(upscale2d(x), w, b, s, compute_dtype=dt)
            err = float((fused().float() - plain().float()).abs().max())
            check(err < (1e-3 if dt == torch.float32 else 0.25),
                  f"fused block {i} {dt}: |diff| {err}")
            plain_ms, fused_ms = abba_ms(plain, fused)
            print(f"[6 times] block {i} conv0 {depths[i - 1]}->{depths[i]} at "
                  f"{res}->{2 * res} {str(dt)[6:]}: dilated {fused_ms:.4f} ms, "
                  f"conv(upscale2d) {plain_ms:.4f} ms (max |diff| {err:.3g}) ({card})")


def check_train_kernels(kernels, path_shapes, gen):
    """Phase 7: the backward kernel and the minibatch-stddev kernel against
    their plain versions at every branch (the branch each input took as the
    C side picks it, asserted as in phase 3), two minibatch-stddev calls
    bit for bit, and the minibatch-stddev rule's first and second
    derivatives. Returns {kernel: {dtype: max |diff|}}."""
    max_err = {name: {dt: 0.0 for dt in TOL}
               for name in ("lrelu_pixel_norm_bwd", "minibatch_stddev_stat")}
    bwd_cases = ([(shape, None) for shape in sorted(set(path_shapes)) + BWD_BRANCH_SHAPES]
                 + [(shape, which) for shape in MISALIGNED for which in ("x", "g")])
    branches = {}
    with torch.no_grad():
        for dt in TOL:
            for shape, shifted in bwd_cases:
                x, g = (misaligned_rows(shape, dt, gen) if shifted == name
                        else nhwc(shape, dt, gen) for name in ("x", "g"))
                label = f"{list(shape)}{f' {shifted} +1' if shifted else ''} {str(dt)[6:]}"
                plan = branches[label] = kernels.row_kernel_plan(x, g)
                check_row_plan(label, plan, shape[-1], x.element_size(), shifted)
                got = kernels.lrelu_pixel_norm_bwd(x, g)
                want = kernels.lrelu_pixel_norm_bwd_plain(x, g)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **BWD_TOL[dt], msg=lambda m: (
                    f"lrelu_pixel_norm_bwd {label}: {m}"))
                check(got.stride() == want.stride(), f"lrelu_pixel_norm_bwd {label}: strides "
                      f"{got.stride()}, plain {want.stride()}")
                err = float((got.float() - want.float()).abs().max())
                max_err["lrelu_pixel_norm_bwd"][dt] = max(
                    max_err["lrelu_pixel_norm_bwd"][dt], err)
            for shape, sg, shifted in MB_CASES:
                n, f = shape[0], int(np.prod(shape[1:]))
                x = misaligned_rows((n, f), dt, gen) if shifted else nhwc(shape, dt, gen)
                label = f"{list(shape)}{' +1' if shifted else ''} sg {sg} {str(dt)[6:]}"
                plan = branches[label] = kernels.minibatch_stddev_plan(x, sg)
                vector = not shifted and f * x.element_size() % 16 == 0
                check(plan == (16 // x.element_size() if vector else 1),
                      f"minibatch_stddev_stat {label}: {plan} values a load")
                got = kernels.minibatch_stddev_stat(x, sg)
                again = kernels.minibatch_stddev_stat(x, sg)
                want = kernels.minibatch_stddev_stat_plain(x, sg)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"minibatch_stddev_stat {label}: two calls "
                      f"differ by {float((got - again).abs().max()):.3g}")
                torch.testing.assert_close(got, want, **MB_TOL, msg=lambda m: (
                    f"minibatch_stddev_stat {label}: {m}"))
                err = float((got - want).abs().max())
                max_err["minibatch_stddev_stat"][dt] = max(
                    max_err["minibatch_stddev_stat"][dt], err)
    print("[7 kernels] branches (backward: lanes a row, 16-byte vectors a lane, (0, 0) = "
          "generic; minibatch-stddev: values a load, 1 = generic): "
          + ", ".join(f"{k} {v}" for k, v in branches.items()))
    for name, errs in max_err.items():
        cases = bwd_cases if name == "lrelu_pixel_norm_bwd" else MB_CASES
        tol = BWD_TOL if name == "lrelu_pixel_norm_bwd" else {dt: MB_TOL for dt in TOL}
        print(f"[7 kernels] {name}: {len(cases)} inputs match the plain version"
              f"{'' if name == 'lrelu_pixel_norm_bwd' else ', two calls equal bit for bit'}; "
              f"max |diff| f32 {errs[torch.float32]:.3g} ({tol[torch.float32]}), "
              f"bf16 {errs[torch.bfloat16]:.3g} ({tol[torch.bfloat16]})")

    # Derivatives: the rule's backward (torch ops) against autograd of the
    # plain version, through R1's pattern grad(create_graph=True) then grad.
    x = nhwc((BATCH, 4, 4, 512), torch.float32, gen).requires_grad_(True)
    w = torch.randn((BATCH // 4,), generator=gen, device=DEVICE)
    v = torch.randn(x.shape, generator=gen, device=DEVICE)
    derivs = []
    for fn in (kernels.minibatch_stddev_stat, kernels.minibatch_stddev_stat_plain):
        (g1,) = torch.autograd.grad((fn(x, 4) * w).sum(), x, create_graph=True)
        check(g1.requires_grad, "the first derivative is not differentiable")
        (g2,) = torch.autograd.grad((g1 * v).sum(), x)
        derivs.append((g1.detach(), g2))
    (k1, k2), (p1, p2) = derivs
    scale1, scale2 = float(p1.abs().max()), float(p2.abs().max())
    err1, err2 = float((k1 - p1).abs().max()), float((k2 - p2).abs().max())
    # Relative to the largest entry: the two differ in summation order and
    # in the formula (the rule drops the mean's term, which is zero).
    check(err1 <= 1e-4 * scale1 and err2 <= 1e-4 * scale2,
          f"minibatch-stddev derivatives: |diff| {err1:.3g} of {scale1:.3g}, "
          f"{err2:.3g} of {scale2:.3g}")
    print(f"[7 kernels] minibatch_stddev_stat derivatives at {[BATCH, 4, 4, 512]} "
          f"f32, rule vs autograd of plain: first max |diff| {err1:.3g} (largest "
          f"entry {scale1:.3g}), second {err2:.3g} (largest {scale2:.3g}); bound "
          f"1e-4 of the largest entry")
    return max_err


def train_checkpoint(ckpt_lib, cfg, depths, tmp):
    """A JAX-format G+D checkpoint at scale 6, full width, numpy-seeded
    weights and a fresh Adam state; the schedule inside scale 6 at alpha
    0.5 with no jump within the run. Returns (args, G arrays, D arrays,
    start step)."""
    arrays_g = numpy_generator_arrays(1234, int(cfg.latent_dim), depths, SCALE)
    arrays_d = numpy_discriminator_arrays(4321, depths, SCALE)
    args, start, schedule = train_args(cfg, tmp)
    for name, arrays in (("G", arrays_g), ("D", arrays_d)):
        ckpt_lib.save_checkpoint(tmp, "smoke_init", name, start, params=arrays,
                                 opt=fresh_adam_arrays(arrays),
                                 meta={"args": args, "schedule": schedule})
    return args, arrays_g, arrays_d, start


def train_args(cfg, tmp):
    """The args of the training checkpoints (phases 8 and 16): configs.yaml's
    with batch BATCH, a loss line every step, a checkpoint every 2, r1 every
    step, synthetic data; the start step inside scale 6 at alpha 0.5 with
    no jump within the runs, and the schedule there. Returns (args, start,
    schedule)."""
    args = cfg.to_dict()
    args.update(batch_per_gpu=BATCH, loss_cycle=1, ckpt_cycle=2,
                data_backend="synthetic", use_validation=False, fid_cycle=0,
                loss_mode="r1", r1_interval=1, compute_dtype="float32",
                save_root=tmp)
    scale_end = sum(int(n) for n in args["max_step_at_scale"][:SCALE + 1])
    scale_start = scale_end - int(args["max_step_at_scale"][SCALE])
    # alpha reached 0.5 at its 200th of 400 jumps, 100 steps apart
    start = scale_start + int(args["alpha_jump_start"][SCALE]) + 199 * 100 + 50
    schedule = {"scale_index": SCALE, "alpha": ALPHA, "alpha_index": 200,
                "alpha_jump_value": 1.0 / 400, "next_scale_jump_step": scale_end,
                "next_alpha_jump_step": start + 50}
    return args, start, schedule


def run_train(train_mod, kernels, ckpt_lib, cfg, depths, tmp):
    """Phase 8: the training slice through `pggan_tpu_torch.train.main`.
    Returns (launches of the run, args, G arrays, D arrays)."""
    args, arrays_g, arrays_d, start = train_checkpoint(ckpt_lib, cfg, depths, tmp)
    config = os.path.join(tmp, "smoke_train.yaml")
    with open(config, "w") as f:
        json.dump({"save_root": tmp}, f)            # JSON is YAML
    end = start + TRAIN_STEPS
    out = io.StringIO()
    # The branch of each backward call, asked of the C side before the call
    # (no launch, no count).
    bwd_plans = collections.Counter()
    bwd = kernels.lrelu_pixel_norm_bwd

    def planned_bwd(x, g, *args):
        bwd_plans[kernels.row_kernel_plan(x, g)] += 1
        return bwd(x, g, *args)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), mock.patch.object(
            kernels, "lrelu_pixel_norm_bwd", planned_bwd):
        rc = train_mod.main(["smoke_train", "--config", config, "--ckpt_id",
                             "smoke_init", "--max_step", str(end), "--compute_dtype",
                             "bfloat16", "--device", DEVICE])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"[8 train]   {line}")
    check(rc == 0, f"train main returned {rc}")
    losses = [line for line in lines if line.startswith("lossD:")]
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} loss lines")
    for line in losses:
        d, g = line.replace("lossD:", "").split("| lossG:")
        check(np.isfinite(float(d)) and np.isfinite(float(g)), f"loss line {line!r}")
    per_step = STEP_LAUNCHES
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    check(launches == want, f"launches {launches}, expected {want}")
    check(sum(bwd_plans.values()) == want["lrelu_pixel_norm_bwd"] and (0, 0) not in bwd_plans,
          f"backward branches {dict(bwd_plans)}: expected the vector branch for every call")
    ckpt_steps = sorted(int(f.split("_")[1][:-4]) for f in os.listdir(
        ckpt_lib.ckpt_dir(tmp, "smoke_train")) if f.startswith("G_") and "latest" not in f)
    check(ckpt_steps == [start + 2, end], f"checkpoint steps {ckpt_steps}")
    for name, before in (("G", arrays_g), ("D", arrays_d)):
        params, opt, meta = ckpt_lib.load_checkpoint(tmp, "smoke_train", name, end)
        check(set(params) == set(before), f"{name}: params key set")
        check(set(opt) == set(fresh_adam_arrays(before)), f"{name}: opt key set")
        check(int(opt["0/count"]) == TRAIN_STEPS, f"{name}: Adam count {opt['0/count']}")
        moved = sum(not np.array_equal(params[k], before[k]) for k in before
                    if not k.endswith("/scale"))
        check(moved > 0, f"{name} did not move")
        check(meta["args"]["compute_dtype"] == "bfloat16", f"{name}: args")
    print(f"[8 train] pggan_tpu_torch.train.main resumed a JAX-format scale-{SCALE} "
          f"checkpoint at step {start} and ran {TRAIN_STEPS} r1 steps at {RES}x{RES}, "
          f"batch {BATCH}, bf16, in {train_s:.2f} s (checkpoint load, data, steps, "
          f"checkpoints at {ckpt_steps}); G and D moved; launches {launches} = "
          f"{TRAIN_STEPS} steps x {per_step}; backward branches (lanes a row, vectors a "
          f"lane): {dict(bwd_plans)}")
    return launches, args, arrays_g, arrays_d


def train_state(step_mod, cfg, arrays_g, arrays_d):
    from pggan_tpu_torch.models import discriminator, generator
    G = generator.params_from_jax(arrays_g).to(DEVICE)
    D = discriminator.params_from_jax(arrays_d).to(DEVICE)
    return step_mod.init_train_state(cfg, G, D, torch.Generator(device=DEVICE).manual_seed(0))


@contextlib.contextmanager
def recording_lrelu_signs(kernels, signs):
    """Append to `signs`, call by call, (site, shape, x >= 0) for the input
    of every leaky ReLU of G and D: G's epilogues (whichever version of
    `kernels.lrelu_pixel_norm` is in place), G's format layer and D's
    layers (the models' `leaky_relu`)."""
    from pggan_tpu_torch.models import discriminator as d_mod, generator as g_mod

    def recording(site, fn):
        def call(x, *args, **kwargs):
            signs.append((site, tuple(x.shape), x.detach() >= 0))
            return fn(x, *args, **kwargs)
        return call
    with mock.patch.object(kernels, "lrelu_pixel_norm",
                           recording("G epilogue", kernels.lrelu_pixel_norm)), \
            mock.patch.object(g_mod, "leaky_relu", recording("G format", g_mod.leaky_relu)), \
            mock.patch.object(d_mod, "leaky_relu", recording("D", d_mod.leaky_relu)):
        yield


def sign_flips(signs_a, signs_b):
    """[(call index, site, shape, inputs whose side of 0 differs)] for the
    calls with any, between two runs that made the same leaky-ReLU calls in
    the same order. The calls of an r1 step come in the order G(z1), D on
    the reals, D on its fakes, G(z2), D on G(z2)'s fakes (the G phase)."""
    check(len(signs_a) == len(signs_b), f"{len(signs_a)} vs {len(signs_b)} leaky-ReLU calls")
    flips = []
    for i, ((site, shape, a), (site_b, shape_b, b)) in enumerate(zip(signs_a, signs_b)):
        check((site, shape) == (site_b, shape_b), f"leaky-ReLU call {site} {shape} vs "
                                                  f"{site_b} {shape_b}")
        n = int((a != b).sum())
        if n:
            flips.append((i, site, list(shape), n))
    return flips


def draw_inputs(cfg, gen):
    """A step's uint8 batch and its two latent batches, in that order, from gen."""
    batch = torch.randint(0, 256, (BATCH, RES, RES, 3), generator=gen, device=DEVICE,
                          dtype=torch.uint8)
    z1 = torch.randn((BATCH, int(cfg.latent_dim)), generator=gen, device=DEVICE)
    z2 = torch.randn((BATCH, int(cfg.latent_dim)), generator=gen, device=DEVICE)
    return batch, z1, z2


def step_runs(step_mod, kernels, equalized, cfg, arrays_g, arrays_d, gen, labels,
              signs=None):
    """One step for each label of labels ("kernel", "plain", "kernel
    again"), each from the same state, batch and latents (drawn from gen).
    Returns {label: (losses, {net: Adam state in the JAX layout})}. With a
    dict `signs`, each label's leaky-ReLU input signs go to signs[label]."""
    batch, z1, z2 = draw_inputs(cfg, gen)
    step = step_mod.make_train_step(cfg, SCALE)
    runs = {}
    for label in labels:
        state = train_state(step_mod, cfg, arrays_g, arrays_d)
        recorder = (recording_lrelu_signs(kernels, signs.setdefault(label, []))
                    if signs is not None and label in ("kernel", "plain")
                    else contextlib.nullcontext())
        with plain_kernels(kernels) if label == "plain" else contextlib.nullcontext(), \
                recorder:
            metrics, _ = step(state, batch, ALPHA, z1=z1, z2=z2)
        runs[label] = ({k: float(v) for k, v in metrics.items()},
                       {n: equalized.adam_state_to_jax(o, net) for n, net, o in
                        (("D", state.D, state.opt_D), ("G", state.G, state.opt_G))})
    return runs


def step_difference(runs, a, b):
    """Run a against run b: the largest relative loss difference, and per
    network {net: (gradient max |diff| over the largest |g|, the parameter
    where it is largest)} (Adam's first moment after one step = the
    gradient, β1 = 0)."""
    (m_a, mom_a), (m_b, mom_b) = runs[a], runs[b]
    loss = max(abs(m_a[k] - m_b[k]) / max(abs(m_b[k]), 1e-12) for k in m_b)
    grads = {}
    for net in ("D", "G"):
        keys = [k for k in mom_b[net] if k.startswith("0/mu/")]
        largest = max(float(np.abs(mom_b[net][k]).max()) for k in keys)
        diff, where = max((float(np.abs(mom_a[net][k] - mom_b[net][k]).max()), k)
                          for k in keys)
        grads[net] = (diff / largest, where[len("0/mu/"):])
    return loss, grads


def compare_step(step_mod, kernels, equalized, cfg, arrays_g, arrays_d):
    """Phase 9: one f32 step (TF32 off, cuDNN's deterministic algorithms, D's
    learning rate 0) with the kernels and one with the plain versions, from
    the same state, batch and latents, for each of STEP_DRAWS (r1, counting
    the leaky-ReLU inputs that change side) and WGANGP_DRAWS (wgangp); on
    the first the kernel path once more."""
    cfg = copy.deepcopy(cfg)
    cfg["lr_D"] = 0.0
    wgangp_cfg = copy.deepcopy(cfg)
    wgangp_cfg["loss_mode"] = "wgangp"
    worst = {}
    torch.backends.cudnn.deterministic = True
    try:
        draws = ([(cfg, d) for d in STEP_DRAWS] + [(wgangp_cfg, d) for d in WGANGP_DRAWS])
        for i, (run_cfg, (seed, offset)) in enumerate(draws):
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            if offset:
                gen.set_offset(offset)
            labels = ("kernel", "plain", "kernel again") if i == 0 else ("kernel", "plain")
            signs = {} if run_cfg is cfg else None
            runs = step_runs(step_mod, kernels, equalized, run_cfg, arrays_g, arrays_d, gen,
                             labels, signs)
            print(f"[9 step] f32 TF32 off, {RES}x{RES} batch {BATCH}, {run_cfg.loss_mode}, "
                  f"draw (seed {seed}, offset {offset}): kernel path losses "
                  f"{ {k: round(v, 6) for k, v in runs['kernel'][0].items()} }")
            if signs is not None:
                flips = sign_flips(signs["kernel"], signs["plain"])
                sites = [site for site, _, _ in signs["kernel"]]
                del signs
                # where G's calls and D's take turns: G(z1), D on the reals and
                # on its fakes, G(z2), D on G(z2)'s fakes
                turns = [i for i, site in enumerate(sites) if i == 0 or (
                    site.startswith("G") != sites[i - 1].startswith("G"))]
                print(f"[9 step]   leaky-ReLU inputs on the other side of 0, kernel vs "
                      f"plain path: {sum(n for *_, n in flips)} over {len(sites)} calls "
                      f"(G and D take turns at calls {turns}); (call, site, shape, count) "
                      f"where any: {flips}")
            for a, b in (("kernel", "plain"), ("kernel again", "kernel"))[:len(labels) - 1]:
                loss, grads = step_difference(runs, a, b)
                seen = worst.get(a, (0.0, 0.0))
                worst[a] = (max(seen[0], loss), max([seen[1]] + [r for r, _ in grads.values()]))
                print(f"[9 step]   {a} vs {b}: largest relative loss difference {loss:.3g}; "
                      f"gradient (Adam mu, beta1 = 0) max |diff| over the largest |g|: "
                      + ", ".join(f"{net} {r:.3g} ({where})"
                                  for net, (r, where) in grads.items()))
    finally:
        torch.backends.cudnn.deterministic = False
    loss_rel, grad_rel = worst["kernel"]
    check(worst["kernel again"] == (0.0, 0.0),
          f"the kernel path twice differs: {worst['kernel again']}")
    check(loss_rel <= STEP_LOSS_RTOL, f"loss difference {loss_rel:.3g}")
    check(grad_rel <= STEP_GRAD_RTOL, f"gradient difference {grad_rel:.3g}")
    print(f"[9 step] over {len(STEP_DRAWS)} r1 draws and {len(WGANGP_DRAWS)} wgangp, kernel "
          f"vs plain: losses {loss_rel:.3g} "
          f"(rtol {STEP_LOSS_RTOL}), gradients {grad_rel:.3g} of the largest gradient of "
          f"each network ({STEP_GRAD_RTOL}); the kernel path twice bit for bit")


@contextlib.contextmanager
def forced_lrelu(kernels, signs, nets):
    """Replay the leaky-ReLU calls of a run recorded by
    `recording_lrelu_signs`: in call order, a call of a network in `nets`
    ("G", "D") takes where(recorded x >= 0, x, slope·x) (G's epilogue then
    pixel-normalises as the plain version does), the others run as they
    are. Checks that the calls come in the recorded order."""
    from pggan_tpu_torch.models import discriminator as d_mod, generator as g_mod
    records = iter(signs)

    def lrelu(x, mask, slope=0.2):
        return torch.where(mask, x, x * slope)

    def epilogue(x, mask, slope=0.2, eps=kernels.EPS):
        z = lrelu(x.float(), mask, slope)
        return (z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + eps)).to(x.dtype)

    def replay(site, fn, forced):
        def call(x, *args, **kwargs):
            got, shape, mask = next(records)
            check((got, shape) == (site, tuple(x.shape)),
                  f"replayed call {site} {tuple(x.shape)}, recorded {got} {shape}")
            if site.split()[0] in nets:
                return forced(x, mask, *args, **kwargs)
            return fn(x, *args, **kwargs)
        return call
    with mock.patch.object(kernels, "lrelu_pixel_norm", replay(
            "G epilogue", kernels.lrelu_pixel_norm, epilogue)), \
            mock.patch.object(g_mod, "leaky_relu", replay("G format", g_mod.leaky_relu, lrelu)), \
            mock.patch.object(d_mod, "leaky_relu", replay("D", d_mod.leaky_relu, lrelu)):
        yield


def probe_run(step_mod, equalized, kernels, cfg, arrays_g, arrays_d, inputs, path, signs=None,
              forced=None):
    """One f32 step on `path` ("kernel" or "plain"), recording the leaky-ReLU
    signs into `signs` or replaying `forced` = (signs, nets). Returns (G's
    gradient in the JAX layout, {"x": the input of torgb/PROBE_TORGB in the
    G phase, "g": the gradient at its output})."""
    state = train_state(step_mod, cfg, arrays_g, arrays_d)
    seen = {}

    def hook(module, args, out):
        if torch.is_grad_enabled() and out.requires_grad:           # the G phase
            seen["x"] = args[0].detach()
            out.register_hook(lambda g: seen.__setitem__("g", g.detach()))
    handle = state.G.torgb[PROBE_TORGB].register_forward_hook(hook)
    batch, z1, z2 = inputs
    with contextlib.ExitStack() as stack:
        if path == "plain":
            stack.enter_context(plain_kernels(kernels))
        if signs is not None:
            stack.enter_context(recording_lrelu_signs(kernels, signs))
        if forced is not None:
            stack.enter_context(forced_lrelu(kernels, *forced))
        step_mod.make_train_step(cfg, SCALE)(state, batch, ALPHA, z1=z1, z2=z2)
    handle.remove()
    grads = {k[len("0/mu/"):]: v for k, v in
             equalized.adam_state_to_jax(state.opt_G, state.G).items() if k.startswith("0/mu/")}
    return grads, seen


def grad_rel(a, b):
    """max |a - b| over the largest |b| across G's parameters, and where."""
    largest = max(float(np.abs(v).max()) for v in b.values())
    diff, where = max((float(np.abs(a[k] - b[k]).max()), k) for k in b)
    return diff / largest, where


def probe_step(step_mod, kernels, equalized, cfg, arrays_g, arrays_d):
    """Phase 9's probe (PROBE_DRAWS): is the gradient difference of draw
    (0, 5508) something the kernels compute differently, or rounding that
    both paths share, carried by leaky-ReLU inputs that fall on the other
    side of 0 or by a near-cancelling sum?"""
    cfg = copy.deepcopy(cfg)
    cfg["lr_D"] = 0.0
    key = f"torgb/{PROBE_TORGB}/w"
    torch.backends.cudnn.deterministic = True
    try:
        for seed, offset in PROBE_DRAWS:
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            if offset:
                gen.set_offset(offset)
            inputs = draw_inputs(cfg, gen)
            signs, plain_signs = [], []
            run = functools.partial(probe_run, step_mod, equalized, kernels, cfg, arrays_g,
                                    arrays_d, inputs)
            kernel, seen_k = run("kernel", signs=signs)
            plain, seen_p = run("plain", signs=plain_signs)
            forced_d, _ = run("plain", forced=(signs, ("D",)))
            forced_all, _ = run("plain", forced=(signs, ("G", "D")))
            rel = {name: grad_rel(kernel, other) for name, other in (
                ("plain", plain), ("plain, D forced", forced_d),
                ("plain, G and D forced", forced_all))}
            print(f"[9 probe] draw (seed {seed}, offset {offset}), f32 TF32 off, deterministic "
                  f"cuDNN, D held: G gradient max |diff| over the largest, kernel path vs "
                  + "; vs ".join(f"{name} {r:.3g} ({where})" for name, (r, where) in rel.items()))
            # the entries of the weight's gradient that differ most
            w_k, w_p = kernel[key][0, 0], plain[key][0, 0]               # [Cin, Cout]
            diff = np.abs(w_k - w_p)
            top = np.dstack(np.unravel_index(np.argsort(diff, axis=None)[::-1][:3],
                                             diff.shape))[0]
            print(f"[9 probe]   {key}: largest |g| {np.abs(w_p).max():.4g}; entries (in, out) "
                  f"that differ most: " + ", ".join(
                      f"({i}, {o}) {w_k[i, o]:.6g} vs {w_p[i, o]:.6g}" for i, o in top))
            # that entry's gradient, pixel by pixel: scale·x[b, i, h, w]·g[b, o, h, w]
            i, o = (int(v) for v in top[0])
            scale = float(arrays_g[key.replace("/w", "/scale")])
            terms = {}
            for name, seen in (("kernel", seen_k), ("plain", seen_p)):
                x, g = seen["x"][:, i].double(), seen["g"][:, o].double()
                terms[name] = (scale * x * g, x, g)
            t_k, x_k, g_k = terms["kernel"]
            t_p, x_p, g_p = terms["plain"]
            d = (t_k - t_p).flatten()
            order = torch.argsort(d.abs(), descending=True)
            total = float(d.sum())
            shares = {n: float(d[order[:n]].sum()) / total for n in (1, 10, 100, 1000)}
            fwd = float((scale * (x_k - x_p) * g_p).sum())
            bwd = float((scale * x_k * (g_k - g_p)).sum())
            print(f"[9 probe]   ({i}, {o}): sum of the pixel terms {float(t_k.sum()):.6g} "
                  f"(Adam mu {w_k[i, o]:.6g}); sum of |terms| / |sum| = "
                  f"{float(t_p.abs().sum()) / abs(float(t_p.sum())):.4g}; the difference "
                  f"{total:.4g} = forward part (x differs) {fwd:.4g} + backward part (g "
                  f"differs) {bwd:.4g}; share of it in the 1, 10, 100, 1000 pixels that carry "
                  f"most: " + ", ".join(f"{v:.3f}" for v in shares.values()))
            # flips near the pixels that carry it: D's calls after G's last
            # (the G phase, D on G(z2)'s fakes) and G's 128² epilogues in G(z2)
            last_g = max(n for n, (site, _, _) in enumerate(signs) if site.startswith("G"))
            first_g2 = max(n for n, (site, _, _) in enumerate(signs[:last_g])
                           if not site.startswith("G")) + 1
            flips = []
            for n, ((site, shape, a), (_, _, b)) in enumerate(zip(signs, plain_signs)):
                if len(shape) == 4 and (n > last_g or (n >= first_g2 and site == "G epilogue")):
                    where = torch.nonzero(a != b)
                    if len(where):
                        flips.append((site, shape[2], where))
            rows = []
            side = x_k.shape[-1]
            for flat in order[:PROBE_TOP].tolist():
                b0, h0, w0 = np.unravel_index(flat, tuple(t_k.shape))
                near = collections.Counter()
                for site, res, where in flips:
                    same = where[where[:, 0] == b0]
                    hh = (same[:, 2].double() + 0.5) * side / res
                    ww = (same[:, 3].double() + 0.5) * side / res
                    close = ((hh - h0).abs() <= PROBE_RADIUS + side / res / 2) & (
                        (ww - w0).abs() <= PROBE_RADIUS + side / res / 2)
                    if int(close.sum()):
                        near[f"{site.split()[0]}@{res}"] += int(close.sum())
                rows.append(f"(b {b0}, h {h0}, w {w0}) {float(d[flat]) / total:+.3f} of it, "
                            f"x {float(x_k[b0, h0, w0]):.4g} g {float(g_k[b0, h0, w0]):.4g}, "
                            f"flips {dict(near) or 0}")
            n_flips = sum(len(w) for *_, w in flips)
            print(f"[9 probe]   the {PROBE_TOP} pixels that carry most (share of the "
                  f"difference, the kernel path's x and g, flips of the G phase within "
                  f"{PROBE_RADIUS} px at {side}² in the same sample, by network@resolution; "
                  f"{n_flips} flips in the G phase in all): " + "; ".join(rows))
            del signs, plain_signs
    finally:
        torch.backends.cudnn.deterministic = False


def time_train(step_mod, kernels, cfg, arrays_g, arrays_d, gen, card):
    """Phase 10a: step ms, img/s and peak memory of the R1 step, the step
    without R1 and the wgangp step, in bf16, f32 with TF32 off and f32 with
    TF32 on. Returns the bf16 step ms {R1: ms} (R1 True, False, "wgangp")."""
    bf16_ms = {}
    batch = torch.randint(0, 256, (BATCH, RES, RES, 3), generator=gen, device=DEVICE,
                          dtype=torch.uint8)
    for label, dtype, tf32 in (("bf16", "bfloat16", False),
                               ("f32 TF32 off", "float32", False),
                               ("f32 TF32 on", "float32", True)):
        run_cfg = copy.deepcopy(cfg)
        run_cfg["compute_dtype"] = dtype
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        state = train_state(step_mod, run_cfg, arrays_g, arrays_d)
        wgangp_cfg = copy.deepcopy(run_cfg)
        wgangp_cfg["loss_mode"] = "wgangp"
        for r1 in (True, False, "wgangp"):
            step = (step_mod.make_train_step(wgangp_cfg, SCALE) if r1 == "wgangp" else
                    step_mod.make_train_step(run_cfg, SCALE, include_r1=r1))
            for _ in range(2):
                step(state, batch, ALPHA)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n = 5
            t0 = time.perf_counter()
            for _ in range(n):
                step(state, batch, ALPHA)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / n * 1e3
            if label == "bf16":
                bf16_ms[r1] = ms
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            kind = {True: "R1", False: "no R1 (lazy-window tail)",
                    "wgangp": "wgangp (GP + drift)"}[r1]
            print(f"[10 times] train step {RES}x{RES} batch {BATCH} {label}, {kind}: {ms:.2f} ms = "
                  f"{BATCH / ms * 1e3:.1f} img/s; peak memory {peak:.0f} MiB "
                  f"(host clock over {n} steps after 2 warm-up) ({card})")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return bf16_ms


def time_train_kernels(kernels, gen, card):
    """Phase 10b: the train path's kernels against their plain versions (no
    one PyTorch call computes either), f32 and bf16: the backward at the
    three largest epilogue shapes (BWD_TIMED), with its GB/s and share of
    its bound; the minibatch-stddev kernel at [16, 4, 4, 512] sg 4, its
    call (autograd not recording) in the same turns as pixel_norm's call at
    that shape. Call time and device time. Uses only wrapper calls that
    every checkout of the port has (`lrelu_pixel_norm_bwd(x, g)`,
    `minibatch_stddev_stat(x, sg)`, `pixel_norm(x)`), so
    tools/time_row_kernels.py runs it on a parent checkout too. Returns
    {(kernel, shape, dtype): (call ms, device ms, plain ms)} and {dtype:
    pixel_norm call ms}."""
    times, pixel_norm_calls = {}, {}
    for shape, dt in itertools.product(BWD_TIMED, (torch.float32, torch.bfloat16)):
        x, g = nhwc(shape, dt, gen), nhwc(shape, dt, gen)
        kernel = lambda: kernels.lrelu_pixel_norm_bwd(x, g)  # noqa: E731
        plain_ms, kernel_ms = abba_ms(lambda: kernels.lrelu_pixel_norm_bwd_plain(x, g), kernel)
        kernel_dev = device_ms(kernel, kernels, "lrelu_pixel_norm_bwd")
        times[("lrelu_pixel_norm_bwd", shape, dt)] = (kernel_ms, kernel_dev, plain_ms)
        nbytes = 3 * x.numel() * x.element_size()
        b_ms, _ = bound_ms(nbytes, 12 * x.numel())
        print(f"[10 times] lrelu_pixel_norm_bwd {list(shape)} {str(dt)[6:]}: kernel call "
              f"{kernel_ms:.4f} ms, device {kernel_dev:.4f} ms ({nbytes / kernel_dev / 1e6:.0f} "
              f"GB/s of two reads + one write; bound {b_ms:.4f} ms, "
              f"{100 * b_ms / kernel_dev:.0f} % of it reached); plain call {plain_ms:.4f} ms "
              f"({card})")
    shape = (BATCH, 4, 4, 512)
    for dt in (torch.float32, torch.bfloat16):
        m = nhwc(shape, dt, gen)
        kernel = lambda: kernels.minibatch_stddev_stat(m, 4)  # noqa: E731
        plain_ms, kernel_ms, pn_ms = abba_ms(
            lambda: kernels.minibatch_stddev_stat_plain(m, 4), kernel,
            lambda: kernels.pixel_norm(m), iters=SMALL_ITERS)
        kernel_dev = device_ms(kernel, kernels, "minibatch_stddev_stat")
        times[("minibatch_stddev_stat", shape, dt)] = (kernel_ms, kernel_dev, plain_ms)
        pixel_norm_calls[dt] = pn_ms
        print(f"[10 times] minibatch_stddev_stat {list(shape)} sg 4 {str(dt)[6:]}: kernel "
              f"call {kernel_ms:.4f} ms ({kernel_ms / pn_ms:.2f}x pixel_norm's call "
              f"{pn_ms:.4f} ms at that shape, same turns), device {kernel_dev:.4f} ms; plain "
              f"call {plain_ms:.4f} ms ({card})")
    return times, pixel_norm_calls


@contextlib.contextmanager
def plain_bias_act(kernels):
    """Route bias_act's leaky ReLU (and so filtered_lrelu's) to the plain
    version of bias_lrelu_gain, for comparison and timing only."""
    with mock.patch.object(kernels, "bias_lrelu_gain", kernels.bias_lrelu_gain_plain):
        yield


def check_bias_act_kernel(kernels, path_shapes, gen):
    """Phase 11a: the bias_lrelu_gain kernel against its plain version, f32
    and bf16, at every conv-epilogue shape, [16, 512] and three ragged
    shapes; an f32 bias, a bias in x's dtype and none; (slope, gain) of
    (0.2, √2) and (0.1, 1). Returns {dtype: max |diff|}."""
    shapes = [(BATCH, 512)] + sorted(set(path_shapes)) + RAGGED
    max_err = {dt: 0.0 for dt in TOL}
    calls = 0
    with torch.no_grad():
        for shape in shapes:
            for dt, tol in TOL.items():
                x = nhwc(shape, dt, gen)
                b32 = torch.randn((shape[-1],), generator=gen, device=DEVICE)
                biases = [b32, None] + ([b32.to(dt)] if dt != torch.float32 else [])
                for b, (slope, gain) in itertools.product(biases, BIAS_PARAMS):
                    got = kernels.bias_lrelu_gain(x, b, slope, gain)
                    want = kernels.bias_lrelu_gain_plain(x, b, slope, gain)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, **tol, msg=lambda m: (
                        f"bias_lrelu_gain {shape} {dt} b {None if b is None else b.dtype} "
                        f"({slope}, {gain}): {m}"))
                    check(got.stride() == x.stride(), f"bias_lrelu_gain {shape}: layout")
                    max_err[dt] = max(max_err[dt], float((got.float() - want.float()).abs().max()))
                    calls += 1
    print(f"[11 ops] bias_lrelu_gain: {calls} calls over {len(shapes)} shapes, f32 and bf16 "
          f"x, f32 / x-dtype / no bias, (slope, gain) in {BIAS_PARAMS}, match the plain "
          f"version; max |diff| f32 {max_err[torch.float32]:.3g} ({TOL[torch.float32]}), "
          f"bf16 {max_err[torch.bfloat16]:.3g} ({TOL[torch.bfloat16]})")

    # Refusals on the card: no copy into another layout, no fallback.
    x = nhwc((2, 4, 4, 8), torch.float32, gen)
    for label, call, error in (
            ("NCHW-contiguous", lambda: kernels.bias_lrelu_gain(x.contiguous()), ValueError),
            ("float16", lambda: kernels.bias_lrelu_gain(x.half()), TypeError),
            ("a bias of the wrong length", lambda: kernels.bias_lrelu_gain(
                x, torch.zeros(4, device=DEVICE)), ValueError)):
        try:
            call()
        except error:
            continue
        raise SmokeFailure(f"bias_lrelu_gain took an input that is {label}")
    print("[11 ops] bias_lrelu_gain raises on an NCHW-contiguous input, float16 and a "
          "wrong bias")
    return max_err


def check_bias_act_rule(kernels, gen):
    """Phase 11b: the first and second derivatives of bias_lrelu_gain's
    autograd rule (kernel forward, torch-ops backward) against autograd of
    its plain version, for L = sum(w·y²), then sum(v·dL/dx) + sum(u·dL/db)."""
    shape = (BATCH, 32, 32, 128)
    x = nhwc(shape, torch.float32, gen).requires_grad_(True)
    b = torch.randn((128,), generator=gen, device=DEVICE).requires_grad_(True)
    w, v = nhwc(shape, torch.float32, gen), nhwc(shape, torch.float32, gen)
    u = torch.randn((128,), generator=gen, device=DEVICE)
    derivs = []
    for fn in (kernels.bias_lrelu_gain, kernels.bias_lrelu_gain_plain):
        g1x, g1b = torch.autograd.grad((fn(x, b).square() * w).sum(), (x, b),
                                       create_graph=True)
        check(g1x.requires_grad and g1b.requires_grad,
              "the first derivative is not differentiable")
        g2x, g2b = torch.autograd.grad((g1x * v).sum() + (g1b * u).sum(), (x, b))
        derivs.append((g1x.detach(), g1b.detach(), g2x, g2b))
    report = []
    for name, k, p in zip(("dx", "db", "d2x", "d2b"), *derivs):
        scale, err = float(p.abs().max()), float((k - p).abs().max())
        # The sums over the 16·32·32 positions run in another order.
        check(err <= 1e-5 * scale, f"bias_lrelu_gain {name}: |diff| {err:.3g} of {scale:.3g}")
        report.append(f"{name} {err:.3g} (largest {scale:.3g})")
    print(f"[11 ops] bias_lrelu_gain derivatives at {list(shape)} f32, rule vs autograd "
          f"of plain, max |diff|: {', '.join(report)}; bound 1e-5 of the largest entry")


def check_ops_on_card(ops):
    """Phase 11d: a small case of every ops-layer function on the card
    against the same call on the CPU (numpy-seeded inputs, f32, TF32 off),
    grid_sample's second derivatives included. Tolerance rtol 1e-5, atol
    1e-5: CUDA's and the CPU's math libraries and sum orders differ."""
    rng = np.random.default_rng(5)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    x = arr(2, 8, 9, 6).permute(0, 3, 1, 2)               # NHWC bytes, NCHW view
    b, w3, w_down = arr(6), arr(3, 3, 6, 4), arr(2, 2, 6, 4)
    grid = torch.from_numpy(rng.uniform(-1.2, 1.2, (2, 5, 4, 2)).astype(np.float32))
    f4 = {d: ops.setup_filter([1, 3, 3, 1], device=d) for d in ("cpu", DEVICE)}
    f8 = {d: ops.setup_filter(list(range(1, 9)), device=d) for d in ("cpu", DEVICE)}
    cases = [(f"bias_act {act}{' clamp' if clamp else ''}",
              lambda d, act=act, clamp=clamp: ops.bias_act(
                  x.to(d), b.to(d), act=act, clamp=clamp))
             for act in ACTIVATIONS for clamp in (None, 1.5)]
    cases += [
        ("fma", lambda d: ops.basic.fma(x.to(d), x.to(d), b.to(d).view(1, -1, 1, 1))),
        ("setup_filter", lambda d: f8[d]),
        ("upfirdn2d up 2", lambda d: ops.upfirdn2d(x.to(d), f4[d], up=2, padding=(2, 1, 2, 1))),
        ("upfirdn2d down 2, crop", lambda d: ops.upfirdn2d(x.to(d), f8[d], down=2,
                                                           padding=(3, 2, -1, 4))),
        ("filter2d", lambda d: ops.filter2d(x.to(d), f4[d], flip_filter=True)),
        ("upsample2d", lambda d: ops.upsample2d(x.to(d), f4[d])),
        ("downsample2d", lambda d: ops.downsample2d(x.to(d), f4[d])),
        ("bilinear_align_corners", lambda d: ops.resample.bilinear_align_corners(
            x.to(d), 13, 1)),
        ("filtered_lrelu", lambda d: ops.filtered_lrelu(
            x.to(d), f4[d], f4[d], b.to(d), up=2, down=2, padding=3)),
        ("filtered_lrelu clamp", lambda d: ops.filtered_lrelu(
            x.to(d), f4[d], None, b.to(d), up=2, padding=1, clamp=0.5)),
        ("conv2d_resample", lambda d: ops.conv2d_resample(x.to(d), w3.to(d), padding=1,
                                                          flip_weight=False)),
        ("conv2d_resample up 2", lambda d: ops.conv2d_resample(
            x.to(d), w3.to(d), f4[d], up=2, padding=1)),
        ("conv2d_resample down 2", lambda d: ops.conv2d_resample(
            x.to(d), w3.to(d), f4[d], down=2, padding=1)),
        ("conv2d_resample strided", lambda d: ops.conv2d_resample(
            x.to(d), w_down.to(d), down=2)),
        ("grid_sample", lambda d: ops.grid_sample(x.to(d), grid.to(d))),
    ]
    worst = 0.0
    with torch.no_grad():
        for name, fn in cases:
            want, got = fn("cpu"), fn(DEVICE).cpu()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                       msg=lambda m, name=name: f"{name}: {m}")
            worst = max(worst, float((got - want).abs().max()))

    # grid_sample to second order: d/dgrid of sum(y²), then the gradient of
    # the sum of its squares with respect to the image and the grid.
    second = {}
    for d in ("cpu", DEVICE):
        xd = x.to(d).requires_grad_(True)
        gd = grid.to(d).requires_grad_(True)
        (d_grid,) = torch.autograd.grad(ops.grid_sample(xd, gd).square().sum(), gd,
                                        create_graph=True)
        second[d] = [t.cpu() for t in torch.autograd.grad(d_grid.square().sum(), (xd, gd))]
    report = []
    for name, got, want in zip(("image", "grid"), second[DEVICE], second["cpu"]):
        scale, err = float(want.abs().max()), float((got - want).abs().max())
        check(err <= 1e-4 * scale, f"grid_sample second derivative ({name}): |diff| "
              f"{err:.3g} of {scale:.3g}")
        report.append(f"{name} {err:.3g} (largest {scale:.3g})")
    print(f"[11 ops] {len(cases)} ops-layer calls on the card match the CPU; max |diff| "
          f"{worst:.3g} (rtol 1e-5, atol 1e-5); grid_sample second derivatives, card vs "
          f"CPU: {', '.join(report)}; bound 1e-4 of the largest entry")


def run_ops_path(kernels, ops, gen):
    """Phase 11c: the ops path through its entry points, with every launch
    count set to 0 just before and read just after: bias_act's leaky ReLU at
    the top block's shape in bf16 with an f32 bias, bias_act swish (no
    kernel), and filtered_lrelu at the two top blocks' shapes in f32 (up 2,
    down 2, [1,3,3,1] filters, padding 3, a bias). Then the same calls with
    the plain version (not counted). Returns the launches."""
    f = ops.setup_filter([1, 3, 3, 1], device=DEVICE)
    x_act = nhwc(OPS_SHAPES[-1], torch.bfloat16, gen)
    b_act = torch.randn((OPS_SHAPES[-1][-1],), generator=gen, device=DEVICE)
    inputs = [(nhwc(s, torch.float32, gen), torch.randn((s[-1],), generator=gen,
                                                         device=DEVICE)) for s in OPS_SHAPES]

    def drive():
        return ([ops.bias_act(x_act, b_act, act="lrelu"),
                 ops.bias_act(x_act, b_act, act="swish")]
                + [ops.filtered_lrelu(x, f, f, b, up=2, down=2, padding=3) for x, b in inputs])
    with torch.no_grad():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs = drive()
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        want = dict.fromkeys(launches, 0)
        want["bias_lrelu_gain"] = 1 + len(OPS_SHAPES)
        check(launches == want, f"ops path launches {launches}, expected {want}")
        with plain_bias_act(kernels):
            plain_outs = drive()
    for i, (out, plain) in enumerate(zip(outs, plain_outs)):
        check(out.shape == (x_act if i < 2 else inputs[i - 2][0]).shape, f"out {i} shape")
        check(bool(torch.isfinite(out).all()), f"out {i} is not finite")
        check(out.is_contiguous(memory_format=torch.channels_last), f"out {i} layout")
        torch.testing.assert_close(out, plain, **TOL[out.dtype],
                                   msg=lambda m, i=i: f"ops path out {i}: {m}")
    errs = [float((o.float() - p.float()).abs().max()) for o, p in zip(outs, plain_outs)]
    print(f"[11 ops] ops path in {drive_s:.2f} s: bias_act lrelu and swish at "
          f"{list(OPS_SHAPES[-1])} bf16, filtered_lrelu (up 2, down 2, padding 3, "
          f"[1,3,3,1]) at {[list(s) for s in OPS_SHAPES]} f32: launches {launches}; "
          f"kernel path vs plain path max |diff| {[round(e, 9) for e in errs]}")
    return launches


def time_ops(kernels, ops, gen, card):
    """Phase 11e: the kernel against its plain version at the top block's
    shape, f32 and bf16, and filtered_lrelu with the kernel against it with
    the plain version at both shapes, f32. Returns {(name, dtype or shape):
    (kernel ms, plain ms)}."""
    times = {}
    big = OPS_SHAPES[-1]
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            x = nhwc(big, dt, gen)
            b = torch.randn((big[-1],), generator=gen, device=DEVICE)
            kernel = lambda: kernels.bias_lrelu_gain(x, b)  # noqa: E731
            plain_ms, kernel_ms = abba_ms(lambda: kernels.bias_lrelu_gain_plain(x, b), kernel)
            kernel_dev = device_ms(kernel, kernels, "bias_lrelu_gain")
            times[("bias_lrelu_gain", dt)] = (kernel_ms, kernel_dev, plain_ms)
            gbps = 2 * x.numel() * x.element_size() / (kernel_dev * 1e-3) / 1e9
            print(f"[11 times] bias_lrelu_gain {list(big)} {str(dt)[6:]}: kernel call "
                  f"{kernel_ms:.4f} ms, device {kernel_dev:.4f} ms ({gbps:.0f} GB/s of one "
                  f"read + one write); plain call {plain_ms:.4f} ms ({card})")
        f = ops.setup_filter([1, 3, 3, 1], device=DEVICE)
        for shape in OPS_SHAPES:
            x = nhwc(shape, torch.float32, gen)
            b = torch.randn((shape[-1],), generator=gen, device=DEVICE)

            def run():
                return ops.filtered_lrelu(x, f, f, b, up=2, down=2, padding=3)

            def plain():
                with plain_bias_act(kernels):
                    return run()
            plain_ms, kernel_ms = abba_ms(plain, run, iters=10)
            times[("filtered_lrelu", shape)] = (kernel_ms, plain_ms)
            print(f"[11 times] filtered_lrelu {list(shape)} f32 (up 2, down 2, padding 3): "
                  f"with the kernel {kernel_ms:.3f} ms, with the plain version "
                  f"{plain_ms:.3f} ms ({card})")
    return times


# ---- phase 12: training from a folder of images ----------------------------

def write_image_folder(root, count=FOLDER_IMAGES, seed=2024):
    """`count` JPEGs of FOLDER_SIDE² in two subdirectories, one level down
    each (so the glob recurses), from a numpy seed: a smooth colour field
    plus noise, so the decode and the resize to 256² do real work."""
    from PIL import Image
    rs = np.random.RandomState(seed)
    for i in range(count):
        sub = os.path.join(root, f"part{i % 2}", "faces")
        os.makedirs(sub, exist_ok=True)
        low = Image.fromarray(rs.randint(0, 256, (10, 10, 3), dtype=np.uint8)).resize(
            (FOLDER_SIDE, FOLDER_SIDE), Image.BILINEAR)
        noise = rs.randint(-24, 25, (FOLDER_SIDE, FOLDER_SIDE, 3))
        arr = np.clip(np.asarray(low, np.int16) + noise, 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(sub, f"{i:03d}.jpg"), quality=90)


def folder_run(train_mod, kernels, argv, hook=None):
    """One `pggan_tpu_torch.train.main` run, its output captured. Returns
    (return code, the batches that reached the step in order, the config
    main built, the output lines, the launches of the run, seconds).
    `hook(trainer)` runs after each single step."""
    from pggan_tpu_torch.data.pipeline import DataPipeline
    from pggan_tpu_torch.train.trainer import ProgressiveGANTrainer

    batches, made = [], {}
    next_batch, step_once = DataPipeline.__next__, ProgressiveGANTrainer.train_step
    create = train_mod.create_model

    def recording_next(self):
        batch = next_batch(self)
        batches.append(batch)
        return batch

    def hooked_step(self):
        images = step_once(self)
        if hook is not None:
            hook(self)
        return images

    def recording_create(cfg, **kwargs):
        made["cfg"] = cfg.to_dict()
        return create(cfg, **kwargs)
    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), \
            mock.patch.object(DataPipeline, "__next__", recording_next), \
            mock.patch.object(ProgressiveGANTrainer, "train_step", hooked_step), \
            mock.patch.object(train_mod, "create_model", recording_create):
        rc = train_mod.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (rc, batches, made.get("cfg"), out.getvalue().splitlines(),
            dict(kernels.launches), seconds)


@contextlib.contextmanager
def recording_trainers(train_mod, trainers):
    """Append every trainer that `train_mod.main` creates to `trainers`."""
    create = train_mod.create_model

    def recording(cfg, **kwargs):
        trainers.append(create(cfg, **kwargs))
        return trainers[-1]
    with mock.patch.object(train_mod, "create_model", recording):
        yield


def executed_launches(launches, trainer):
    """The kernel launches a run executed, from the wrapper calls it counted
    (`launches`) and the trainer's captured steps: a wrapper counts a call at
    capture, which runs nothing, and a replay calls no wrapper but runs the
    capture's launches. Returns (executed, a line that says so)."""
    graphs = trainer._graphs
    if graphs is None or not graphs.captured:
        return dict(launches), f"wrapper calls {launches}, no replays"
    captured = graphs.captured
    at_capture = {k: sum(c.launches[k] for c in captured.values()) for k in launches}
    replayed = graphs.launches_replayed()
    executed = {k: launches[k] - at_capture[k] + replayed[k] for k in launches}
    return executed, (f"wrapper calls {launches} (of them at capture {at_capture}) + "
                      + " + ".join(f"the {kind} step's {c.launches} x {c.replays} replays"
                                   for kind, c in captured.items())
                      + f" = {executed}")


def check_lazy_launches(label, launches, trainer, steps):
    """A lazy-R1 run's executed launches: phase 8's a step, less one
    minibatch-stddev launch a tail step (the tail's reals and fakes go
    through one D forward); the tail steps are the tail graph's replays and
    the eager step before its capture."""
    executed, text = executed_launches(launches, trainer)
    captured = trainer._graphs.captured if trainer._graphs is not None else {}
    tails = captured["tail"].replays + 1 if "tail" in captured else 0
    want = {k: n * steps for k, n in STEP_LAUNCHES.items()}
    want["minibatch_stddev_stat"] -= tails
    check(executed == want, f"{label}: launches {executed}, expected {want}")
    print(f"[{label}] launches: {text} = {steps} steps x {STEP_LAUNCHES}, less one "
          f"minibatch-stddev launch in each of the {tails} tail steps")


def read_metrics(run_dir, steps):
    """metrics.jsonl of a run: one line per loss_cycle step of `steps`, with
    the JAX trainer's keys (imgs_per_sec from the second line on). Returns
    the imgs_per_sec values."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    check([m["step"] for m in lines] == steps, f"metrics.jsonl steps {[m['step'] for m in lines]}")
    keys = {"step", "time", "L_D", "L_D_real", "L_D_fake", "L_D_r1", "L_G"}
    for i, m in enumerate(lines):
        check(set(m) == keys | ({"imgs_per_sec"} if i else set()),
              f"metrics.jsonl keys {sorted(m)}")
        check(all(np.isfinite(v) for v in m.values()), f"metrics.jsonl line {m}")
    return [m["imgs_per_sec"] for m in lines[1:]]


def time_pipeline(images):
    """The pipeline alone at 256², batch 16, 2 batches of prefetch, onto the
    card, with the decode cache filled: batches/s over PIPELINE_BATCHES
    batches (the 2 already queued included), with 8 worker threads and with
    1 (whether the threads scale). Returns {workers: batches/s}."""
    from pggan_tpu_torch.data.dataset import ImageFolderDataset, split_dataset
    from pggan_tpu_torch.data.pipeline import DataPipeline

    dataset = ImageFolderDataset([images], SCALE, cache_decoded=True)
    indices, _ = split_dataset(len(dataset))
    rates = {}
    for workers in (8, 1):
        with DataPipeline(dataset, BATCH, indices=indices, num_workers=workers,
                          prefetch_depth=2, seed=0, device=DEVICE) as pipe:
            if not rates:                   # 4 epochs: every image decoded once
                for _ in range(4 * (len(indices) // BATCH)):
                    next(pipe)
                check(len(dataset._cache) == len(indices),
                      f"{len(dataset._cache)} images cached")
            else:
                next(pipe)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PIPELINE_BATCHES):
                batch = next(pipe)
            torch.cuda.synchronize()
            rates[workers] = PIPELINE_BATCHES / (time.perf_counter() - t0)
        check(batch.device.type == torch.device(DEVICE).type and batch.dtype == torch.uint8,
              "pipeline batch")
    return rates


def run_folder_train(train_mod, kernels, ckpt_lib, cfg, depths, tmp, card, bf16_step_ms):
    """Phase 12: train from a folder of images through the entry point,
    interrupt a run with SIGTERM and resume it; then the rates."""
    from PIL import Image
    from pggan_tpu_torch.config import Config

    t_phase = time.perf_counter()
    _, _, _, start = train_checkpoint(ckpt_lib, cfg, depths, tmp)
    images = os.path.join(tmp, "images")
    write_image_folder(images)
    config = os.path.join(tmp, "folder.yaml")
    with open(config, "w") as f:                    # JSON is YAML
        json.dump({"save_root": tmp, "data_backend": "folder", "dataset_root_list": [images],
                   "batch_per_gpu": BATCH, "num_data_workers": 8, "prefetch_depth": 2,
                   "loss_cycle": 2, "test_cycle": 4, "ckpt_cycle": 4}, f)
    end = start + FOLDER_STEPS

    def argv(run, ckpt_id, max_step=end, *extra):
        return [run, "--config", config, "--ckpt_id", ckpt_id, "--max_step", str(max_step),
                "--compute_dtype", "bfloat16", "--device", DEVICE, *extra]

    # the uninterrupted run
    rc, batches, run_cfg, lines, launches, seconds = folder_run(
        train_mod, kernels, argv("folder", "smoke_init"))
    for line in lines:
        print(f"[12 folder]   {line}")
    check(rc == 0, f"train main returned {rc}")
    check(len(batches) == FOLDER_STEPS, f"{len(batches)} batches reached the step")
    for b in batches:
        check(b.dtype == torch.uint8 and tuple(b.shape) == (BATCH, RES, RES, 3)
              and b.device.type == torch.device(DEVICE).type,
              f"batch {b.dtype} {tuple(b.shape)} {b.device}")
    want = {k: n * FOLDER_STEPS for k, n in STEP_LAUNCHES.items()}
    check(launches == want, f"launches {launches}, expected {want}")
    run_dir = os.path.join(tmp, "folder")
    grid_steps = [s for s in range(start, end) if s % 4 == 0]
    grids = sorted(os.listdir(os.path.join(run_dir, "imgs")))
    check(grids == sorted(f"e{s}.jpg" for s in grid_steps), f"sample grids {grids}")
    per_row = min(BATCH, 8)                         # 2 rows of 8, 2 px apart
    grid_size = (per_row * (RES + 2) + 2, 2 * (RES + 4))
    for name in grids:
        with Image.open(os.path.join(run_dir, "imgs", name)) as img:
            check(img.size == grid_size, f"{name}: {img.size}")
    folder_rates = read_metrics(run_dir, [s for s in range(start, end) if s % 2 == 0])
    snapshot = Config.from_yaml(os.path.join(run_dir, "config_folder.yaml"))
    check(dict(snapshot) == run_cfg, "config_folder.yaml does not reload to the run's config")
    print(f"[12 folder] pggan_tpu_torch.train.main trained from {FOLDER_IMAGES} JPEGs of "
          f"{FOLDER_SIDE}x{FOLDER_SIDE} (2 subdirectories) for {FOLDER_STEPS} r1 steps at "
          f"{RES}x{RES}, batch {BATCH}, bf16, from the scale-{SCALE} checkpoint at step "
          f"{start}, in {seconds:.2f} s; every batch uint8 [{BATCH},{RES},{RES},3] on "
          f"{batches[0].device}; launches {launches} = {FOLDER_STEPS} steps x phase 8's; "
          f"grids {grids} of {grid_size[0]}x{grid_size[1]}; metrics.jsonl "
          f"{len(folder_rates) + 1} lines; config_folder.yaml reloads to the run's config")

    # the same steps on synthetic data
    rc, _, _, _, _, synth_s = folder_run(
        train_mod, kernels, argv("synthetic", "smoke_init", end, "--data_backend", "synthetic"))
    check(rc == 0, f"synthetic run returned {rc}")
    synth_rates = read_metrics(os.path.join(tmp, "synthetic"),
                               [s for s in range(start, end) if s % 2 == 0])

    # SIGTERM after a step, then the resume
    cut = start + SIGTERM_AFTER

    def sigterm(trainer):
        if trainer.global_step == cut:
            os.kill(os.getpid(), signal.SIGTERM)
    handler = signal.getsignal(signal.SIGTERM)
    rc, _, _, lines, _, _ = folder_run(train_mod, kernels, argv("cut", "smoke_init"), sigterm)
    check(rc == 0, f"the interrupted run returned {rc}")
    check(signal.getsignal(signal.SIGTERM) is handler, "SIGTERM handler not restored")
    check(any(f"interrupted at step {cut + 1}" in line for line in lines),
          "no interruption message")
    saved = sorted(f for f in os.listdir(ckpt_lib.ckpt_dir(tmp, "cut")) if "latest" not in f)
    check(f"G_{cut + 1}.npz" in saved and f"D_{cut + 1}.npz" in saved
          and not any(f.endswith(f"_{end}.npz") for f in saved), f"checkpoints {saved}")
    rc, resumed, _, lines, _, _ = folder_run(train_mod, kernels,
                                             argv("cut", "cut", cut + 3))
    check(rc == 0, f"the resumed run returned {rc}")
    check(any(f"checkpoint cut@{cut + 1} restored" in line for line in lines),
          "the resume did not start at the checkpoint")
    check(torch.equal(resumed[0], batches[SIGTERM_AFTER + 1]),
          "the resume's first batch differs from the uninterrupted run's")
    print(f"[12 sigterm] SIGTERM after step {cut}: checkpoint at {cut + 1} ({saved}), clean "
          f"return, handler restored; the resume started at {cut + 1} and its first batch "
          f"equals the uninterrupted run's at {cut + 1} byte for byte")

    pipeline_rates = time_pipeline(images)
    r1_rate, tail_rate = (BATCH / bf16_step_ms[r1] * 1e3 for r1 in (True, False))
    host_rate = pipeline_rates[8] * BATCH
    print(f"[12 rates] card: {card}")
    print(f"[12 rates] data pipeline alone ({RES}x{RES}, batch {BATCH}, prefetch 2, decode "
          f"cache on, onto the card), over {PIPELINE_BATCHES} batches: 8 workers "
          f"{pipeline_rates[8]:.2f} batches/s = {host_rate:.1f} img/s; 1 worker "
          f"{pipeline_rates[1]:.2f} batches/s = {pipeline_rates[1] * BATCH:.1f} img/s")
    print(f"[12 rates] trainer imgs_per_sec, bf16 r1 steps {start}-{end - 1}: folder data "
          f"{folder_rates}, synthetic data {synth_rates} (host clock between loss lines; "
          f"checkpoint and grid steps included)")
    print(f"[12 rates] host keeps up with the bf16 R1 step ({r1_rate:.1f} img/s, phase 10): "
          f"{'yes' if host_rate >= r1_rate else 'no'} ({host_rate / r1_rate:.2f}x); with the "
          f"step without R1 ({tail_rate:.1f} img/s): {'yes' if host_rate >= tail_rate else 'no'}"
          f" ({host_rate / tail_rate:.2f}x)")
    print(f"[12 folder] phase 12 took {time.perf_counter() - t_phase:.2f} s")


# ---- phase 13: validation, FID and KID on the training path -----------------

def launch_delta(kernels, before):
    return {k: kernels.launches[k] - before[k] for k in kernels.launches}


def check_extractors_on_card(fid_mod, inception_mod, card):
    """InceptionV3 (4 images at 299²) and RandomConvFeatures (4 at 256²)
    on the card against the CPU with the same fixed-seed weights, f32 with
    TF32 off (checked) and on (printed)."""
    rs = np.random.RandomState(13)
    for name, build, side, tol in (
            ("InceptionV3Features", lambda d: inception_mod.InceptionV3Features(device=d),
             299, INCEPTION_CARD_TOL),
            ("RandomConvFeatures", lambda d: fid_mod.RandomConvFeatures(feature_dim=256,
                                                                        device=d),
             RES, RANDOM_CONV_CARD_TOL)):
        x = torch.from_numpy(rs.uniform(-1, 1, (4, side, side, 3)).astype(np.float32))
        with torch.inference_mode():
            want = build("cpu")(x)
            net = build(DEVICE)
            got = net(x.to(DEVICE)).cpu()
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = net(x.to(DEVICE)).cpu()
            finally:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
        scale = float(want.abs().max())
        err, err_tf32 = (float((y - want).abs().max()) for y in (got, tf32))
        check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"{name} features")
        check(err <= tol * scale, f"{name} on the card vs the CPU: max |diff| {err:.3g} of "
                                  f"{scale:.3g}")
        print(f"[13 card] {name} [4,{side},{side},3] → {list(got.shape)} f32, card vs CPU: max "
              f"|diff| {err:.3g} TF32 off (bound {tol} x the largest feature {scale:.3g}), "
              f"{err_tf32:.3g} with TF32 on (not bounded) ({card})")


def run_eval_train(train_mod, kernels, ckpt_lib, cfg, depths, tmp, card):
    """Phase 13: validation, FID and KID through `pggan_tpu_torch.train.main`
    at full width, then `pggan_tpu_torch.eval_metrics` on its checkpoint, the
    extractors on the card against the CPU, and the times."""
    from pggan_tpu_torch import eval_metrics
    from pggan_tpu_torch.config import Config
    from pggan_tpu_torch.metrics import fid as fid_mod, inception as inception_mod
    from pggan_tpu_torch.train import trainer as trainer_mod

    t_phase = time.perf_counter()
    recipe = Config.from_yaml(os.path.join(REPO, EVAL_CONFIG))
    check([int(d) for d in recipe.depths] == depths and recipe.latent_dim == cfg.latent_dim,
          f"{EVAL_CONFIG} is not phase 8's model: {recipe.latent_dim}, {recipe.depths}")
    keys = {k: recipe[k] for k in EVAL_KEYS}
    check(keys["use_validation"] and keys["fid_extractor"] == "inception"
          and keys["fid_weights"] is None, f"{EVAL_CONFIG}: {keys}")
    _, _, _, start = train_checkpoint(ckpt_lib, cfg, depths, tmp)
    images = os.path.join(tmp, "eval_images")
    write_image_folder(images, EVAL_IMAGES, seed=2025)
    end = start + EVAL_STEPS
    while (end - 1) % EVAL_FID_CYCLE:
        end += 1
    run_keys = dict(keys, save_root=tmp, data_backend="folder", dataset_root_list=[images],
                    batch_per_gpu=BATCH, num_data_workers=8, prefetch_depth=2, loss_cycle=2,
                    test_cycle=EVAL_TEST_CYCLE, fid_cycle=EVAL_FID_CYCLE, ckpt_cycle=NEVER)
    configs = {}
    for name, over in (("eval", {}), ("noeval", {"use_validation": False, "fid_cycle": 0})):
        configs[name] = os.path.join(tmp, f"{name}.yaml")
        with open(configs[name], "w") as f:             # JSON is YAML
            json.dump(dict(run_keys, **over), f)

    val_launches, fake_launches, fake_meta = [], [], []
    times = collections.defaultdict(list)
    seen = {}
    forward, fakes, scores = (trainer_mod.eval_losses,
                              trainer_mod.ProgressiveGANTrainer.fid_fakes,
                              trainer_mod.generative_scores)
    fit = trainer_mod.ProgressiveGANTrainer.fit

    def counted_forward(*args, **kwargs):
        before = dict(kernels.launches)
        out = forward(*args, **kwargs)
        val_launches.append(launch_delta(kernels, before))
        return out

    def counted_fakes(self, n, batch):
        it = fakes(self, n, batch)
        while True:
            before = dict(kernels.launches)
            try:
                fake = next(it)
            except StopIteration:
                return
            fake_launches.append(launch_delta(kernels, before))
            fake_meta.append((fake.dtype, tuple(fake.shape), fake.device.type,
                              float(fake.min()), float(fake.max())))
            yield fake

    def recorded_scores(f_real, f_fake):
        seen["features"] = (f_real, f_fake)
        return scores(f_real, f_fake)

    def timed(name, fn):
        def call(self, *args, **kwargs):
            seen["trainer"] = self
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return out
        return call

    def timed_methods(suffix, names):
        return [mock.patch.object(trainer_mod.ProgressiveGANTrainer, name, timed(
            name + suffix, getattr(trainer_mod.ProgressiveGANTrainer, name))) for name in names]

    patches = [mock.patch.object(trainer_mod, "eval_losses", counted_forward),
               mock.patch.object(trainer_mod.ProgressiveGANTrainer, "fid_fakes", counted_fakes),
               mock.patch.object(trainer_mod, "generative_scores", recorded_scores)]
    patches += timed_methods("", ("fit", "save_checkpoint", "validation",
                                  "compute_generative_metrics"))

    def argv(run):
        return [run, "--config", configs[run], "--ckpt_id", "smoke_init", "--max_step",
                str(end), "--device", DEVICE]
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        rc, batches, run_cfg, lines, launches, seconds = folder_run(train_mod, kernels,
                                                                    argv("eval"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    for line in lines:
        print(f"[13 eval]   {line}")
    check(rc == 0, f"train main returned {rc}")
    check(run_cfg["compute_dtype"] == "bfloat16" and run_cfg["g_ema_decay"] == 0.999
          and run_cfg["fid_samples"] == keys["fid_samples"], f"the run's config {run_cfg}")
    # 96 images of 256² are 18.9 MB, within device_cache_mb: 'auto' turns it on
    cache_lines = [line for line in lines if "device data cache:" in line]
    print(f"[13 eval] {EVAL_CONFIG}'s device_data_cache: {keys['device_data_cache']!r} "
          f"(device_cache_mb {keys['device_cache_mb']}) turned the cache "
          f"{'on: ' + cache_lines[0] if cache_lines else 'off'}")
    check(keys["device_data_cache"] == "auto" and len(cache_lines) == 1,
          f"expected 'auto' to turn the device data cache on once, got {cache_lines}")
    trainer = seen["trainer"]
    steps = end - start
    check(len(batches) == steps + len(val_launches), f"{len(batches)} batches")

    # metrics.jsonl: val_* at the test_cycle steps, fid/kid/kid_std at the fid_cycle steps
    with open(os.path.join(tmp, "eval", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    val = [r for r in records if "val_L_D" in r]
    scored = [r for r in records if "fid" in r]
    val_steps = [s for s in range(start, end) if s % EVAL_TEST_CYCLE == 0]
    fid_steps = [s for s in range(start, end) if s % EVAL_FID_CYCLE == 0]
    check([r["step"] for r in val] == val_steps and len(val_steps) >= 2,
          f"validation at {[r['step'] for r in val]}, expected {val_steps}")
    check([r["step"] for r in scored] == fid_steps and len(fid_steps) >= 2
          and fid_steps[-1] == end - 1, f"FID at {[r['step'] for r in scored]}, expected "
                                        f"{fid_steps}")
    val_keys = ("val_D_real", "val_D_fake", "val_L_D", "val_L_G", "valid_D_real")
    for r in val:
        check(all(np.isfinite(r[k]) for k in val_keys) and r["val_L_D"] > 0
              and r["val_L_G"] > 0, f"validation record {r}")
    for r in scored:
        check(all(np.isfinite(r[k]) for k in ("fid", "kid", "kid_std")) and r["fid"] >= 0,
              f"FID record {r}")

    # launches: per validation batch, per FID fake batch, and the whole run
    n_fake = -(-int(keys["fid_samples"]) // trainer.fid_batch_size(int(keys["fid_samples"])))
    check(len(val_launches) == len(val) * int(keys["val_batches"])
          and all(d == VAL_LAUNCHES for d in val_launches),
          f"validation batch launches {val_launches}, expected {VAL_LAUNCHES} each")
    check(len(fake_launches) == len(scored) * n_fake
          and all(d == FAKE_LAUNCHES for d in fake_launches),
          f"FID fake batch launches {fake_launches[:3]}..., expected {FAKE_LAUNCHES} each")
    want = {k: steps * STEP_LAUNCHES[k] + len(val_launches) * VAL_LAUNCHES[k]
            + len(fake_launches) * FAKE_LAUNCHES[k] for k in STEP_LAUNCHES}
    check(launches == want, f"launches of the run {launches}, expected {want}")
    for dtype, shape, device, low, high in fake_meta:
        check(dtype == torch.float32 and shape == (BATCH, RES, RES, 3)
              and device == torch.device(DEVICE).type and -1.0 <= low <= high <= 1.0,
              f"FID fake batch {dtype} {shape} {device} [{low}, {high}]")

    # the features the last FID step saw: FID of the reals against themselves
    f_real, f_fake = seen["features"]
    n_real = min(len(trainer._valid_indices), int(keys["fid_samples"]))
    check(f_real.shape == (n_real, inception_mod.FEATURE_DIM)
          and f_fake.shape == (int(keys["fid_samples"]), inception_mod.FEATURE_DIM),
          f"feature shapes {f_real.shape} {f_fake.shape}")
    mu, sigma = f_real.mean(0), np.cov(f_real, rowvar=False)
    fid_self = fid_mod.frechet_distance(mu, sigma, mu, sigma)
    fid_last = scored[-1]["fid"]
    check(fid_self < 1e-2 * fid_last, f"FID of the reals against themselves {fid_self:.4g} "
                                      f"is not far below against the fakes {fid_last:.4g}")
    print(f"[13 eval] pggan_tpu_torch.train.main resumed the scale-{SCALE} checkpoint at step "
          f"{start} with {EVAL_CONFIG}'s evaluation keys {keys} and ran {steps} r1 steps at "
          f"{RES}x{RES}, batch {BATCH}, from {EVAL_IMAGES} JPEGs ({len(trainer._valid_indices)} "
          f"in the valid split), in {seconds:.2f} s; validation at {val_steps}, FID/KID at "
          f"{fid_steps}")
    for r in val:
        print(f"[13 eval]   step {r['step']}: " + ", ".join(f"{k} {r[k]:.5g}" for k in val_keys))
    for r in scored:
        print(f"[13 eval]   step {r['step']}: fid {r['fid']:.6g}, kid {r['kid']:.6g}, kid_std "
              f"{r['kid_std']:.6g}")
    print(f"[13 eval] launches: each of {len(val_launches)} validation batches {VAL_LAUNCHES}; "
          f"each of {len(fake_launches)} FID fake batches {FAKE_LAUNCHES}; the run {launches} = "
          f"{steps} steps x phase 8's + those; fakes f32 [{BATCH},{RES},{RES},3] in [-1, 1] on "
          f"the card; FID of the {n_real} reals against themselves {fid_self:.4g}, against "
          f"the {len(f_fake)} fakes {fid_last:.6g}")

    # the offline entry point on the run's last checkpoint
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = eval_metrics.main(["--ckpt_id", "eval", "--save_root", tmp, "--device", DEVICE])
    check(rc == 0, f"eval_metrics returned {rc}")
    offline = json.loads(out.getvalue().strip().splitlines()[-1])
    check(offline["step"] == end and offline["ema"] and offline["extractor"] == "inception",
          f"eval_metrics {offline}")
    in_run = scored[-1]
    d_fid = abs(offline["fid"] - in_run["fid"])
    d_kid = max(abs(offline[k] - in_run[k]) for k in ("kid", "kid_std"))
    check(d_fid <= EVAL_METRICS_FID_RTOL * in_run["fid"] and d_kid <= EVAL_METRICS_KID_ATOL,
          f"eval_metrics {offline} vs the run's step {end - 1} {in_run}")
    print(f"[13 eval_metrics] python -m pggan_tpu_torch.eval_metrics on checkpoint {end}: "
          f"{json.dumps(offline)}; against the run's step {end - 1}: |dfid| {d_fid:.3g} "
          f"(bound {EVAL_METRICS_FID_RTOL} x fid), |dkid|, |dkid_std| {d_kid:.3g} (bound "
          f"{EVAL_METRICS_KID_ATOL})")

    # the parts of one compute_generative_metrics call, on the run's trainer
    n = int(keys["fid_samples"])
    batch = trainer.fid_batch_size(n)
    t0 = time.perf_counter()
    reals = list(trainer.fid_reals(n, batch))
    t_load = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fake_list = list(fakes(trainer, n, batch))
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    peak_sample = torch.cuda.max_memory_allocated() / 2 ** 20
    extractor = trainer._fid_extractor()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f_r = fid_mod.compute_activations(reals, extractor, max_samples=n)
    f_f = fid_mod.compute_activations(fake_list, extractor, max_samples=n)
    t_extract = time.perf_counter() - t0
    peak_extract = torch.cuda.max_memory_allocated() / 2 ** 20
    again = max(float(np.abs(a - b).max()) for a, b in ((f_r, f_real), (f_f, f_fake)))
    t0 = time.perf_counter()
    stats = [(f.mean(0), np.cov(f, rowvar=False)) for f in (f_r, f_f)]
    t_cov = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid_value = fid_mod.frechet_distance(*stats[0], *stats[1])
    t_eig = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer_mod.kid_between_features(f_r, f_f)
    t_kid = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inception_mod.InceptionV3Features(device=DEVICE)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_img = len(f_r) + len(f_f)
    print(f"[13 times] card: {card}")
    print(f"[13 times] validation(): {[round(t * 1e3, 2) for t in times['validation']]} ms a "
          f"call ({keys['val_batches']} batches of {BATCH}, bf16, host clock with a sync)")
    print(f"[13 times] compute_generative_metrics(): "
          f"{[round(t * 1e3, 1) for t in times['compute_generative_metrics']]} ms a call (the "
          f"first builds InceptionV3: {t_build * 1e3:.1f} ms alone); its parts, one call "
          f"({n_real} reals, {n} fakes): loading the reals {t_load * 1e3:.1f} ms; sampling the "
          f"fakes (f32) {t_sample * 1e3:.1f} ms = {n / t_sample:.1f} img/s; InceptionV3 features "
          f"{t_extract * 1e3:.1f} ms = {n_img / t_extract:.1f} img/s at 299x299 (f32, TF32 "
          f"off); host statistics: np.cov {t_cov * 1e3:.1f} ms, frechet_distance (eigvals of "
          f"a 2048x2048 float64 product) {t_eig * 1e3:.1f} ms, KID {t_kid * 1e3:.1f} ms; fid "
          f"{fid_value:.6g}; features max |diff| from the run's last FID step {again:.3g}; "
          f"peak memory {peak_sample:.0f} MiB sampling (the {n} fakes kept), {peak_extract:.0f} "
          f"MiB extracting, from {base:.0f} MiB allocated before")

    # the same steps without the hooks: fit() less its checkpoint write, so
    # the steps with the hooks and without
    with contextlib.ExitStack() as stack:
        for patch in timed_methods("_noeval", ("fit", "save_checkpoint")):
            stack.enter_context(patch)
        rc, _, _, _, _, _ = folder_run(train_mod, kernels, argv("noeval"))
    check(rc == 0, f"the run without hooks returned {rc}")
    hooks_s = sum(times["validation"]) + sum(times["compute_generative_metrics"])
    on_s, off_s = (times["fit" + k][-1] - sum(times["save_checkpoint" + k])
                   for k in ("", "_noeval"))
    print(f"[13 times] {steps} bf16 r1 steps through fit() from the folder, its final "
          f"checkpoint write left out ({sum(times['save_checkpoint']):.2f} / "
          f"{sum(times['save_checkpoint_noeval']):.2f} s): hooks on {on_s:.2f} s = "
          f"{steps * BATCH / on_s:.2f} img/s, of which the hooks {hooks_s:.2f} s; hooks off "
          f"{off_s:.2f} s = {steps * BATCH / off_s:.2f} img/s; the steps alone with the hooks "
          f"on {steps * BATCH / (on_s - hooks_s):.2f} img/s; peak memory of the run with hooks "
          f"{peak:.0f} MiB ({card})")
    check_extractors_on_card(fid_mod, inception_mod, card)
    print(f"[13 eval] phase 13 took {time.perf_counter() - t_phase:.2f} s")


# ---- phase 14: the device data cache on the training path ------------------

@contextlib.contextmanager
def recording_assembles(calls):
    """Append the (indices, seeds) of every `DeviceDataCache.assemble` call to
    `calls`, in order (the producer thread assembles in stream order)."""
    from pggan_tpu_torch.data.device_cache import DeviceDataCache
    assemble = DeviceDataCache.assemble

    def recording(self, idxs, seeds):
        calls.append((np.array(idxs), np.array(seeds)))
        return assemble(self, idxs, seeds)
    with mock.patch.object(DeviceDataCache, "assemble", recording):
        yield


def time_assembly(images, card, bf16_step_ms):
    """The cache alone at 256², batch 16, augmented: `assemble` calls back to
    back (host draws and copies included; host clock, one sync), the torch
    ops of `assemble_batch` alone (device time, a CUDA graph), and the
    pipeline with the cache delivering batches. Returns img/s of the calls."""
    from pggan_tpu_torch.data.dataset import ImageFolderDataset, split_dataset
    from pggan_tpu_torch.data.device_cache import DeviceDataCache, assemble_batch
    from pggan_tpu_torch.data.pipeline import DataPipeline

    dataset = ImageFolderDataset([images], SCALE)
    cache = DeviceDataCache(dataset, DEVICE)
    rs = np.random.RandomState(0)
    draws = [(rs.randint(0, cache.n_images, BATCH), rs.randint(0, 2 ** 31 - 1, BATCH))
             for _ in range(ASSEMBLE_BATCHES)]
    for idxs, seeds in draws[:3]:
        cache.assemble(idxs, seeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idxs, seeds in draws:
        batch = cache.assemble(idxs, seeds)
    torch.cuda.synchronize()
    call_rate = ASSEMBLE_BATCHES * BATCH / (time.perf_counter() - t0)
    check(batch.dtype == torch.uint8 and tuple(batch.shape) == (BATCH, RES, RES, 3), "batch")
    params = [t.to(DEVICE) for t in (torch.from_numpy(draws[0][0] % cache.n_images),
                                      torch.tensor([1, 0] * (BATCH // 2), dtype=torch.int32),
                                      torch.tensor([[1.1, 0.9, 1.2, 0.005]] * BATCH),
                                      torch.tensor([[3, 1, 0, 2]] * BATCH, dtype=torch.int32))]
    op_ms = device_ms(lambda: assemble_batch(cache.data, *params), calls=5)
    tail_ms = bf16_step_ms[False]
    indices, _ = split_dataset(len(dataset))
    with DataPipeline(dataset, BATCH, indices=indices, num_workers=8, prefetch_depth=2, seed=0,
                      device=DEVICE, assemble_fn=cache.assemble) as pipe:
        for _ in range(3):
            next(pipe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PIPELINE_BATCHES):
            next(pipe)
        torch.cuda.synchronize()
        pipe_rate = PIPELINE_BATCHES * BATCH / (time.perf_counter() - t0)
    print(f"[14 rates] device data cache ({cache.n_images} images, {cache.nbytes / 1e6:.1f} MB "
          f"on the card), {RES}x{RES}, batch {BATCH}, augmented: assemble() back to back "
          f"{call_rate:.1f} img/s (parameter draws and copies included, host clock); "
          f"assemble_batch's torch ops alone {op_ms:.4f} ms a batch = "
          f"{BATCH / op_ms * 1e3:.1f} img/s (device time, CUDA graph) = "
          f"{100 * op_ms / tail_ms:.2f} % of the bf16 step without R1 ({tail_ms:.2f} ms, "
          f"phase 10); the pipeline with the cache {pipe_rate:.1f} img/s over "
          f"{PIPELINE_BATCHES} batches ({card})")
    return call_rate


def run_cache_train(train_mod, kernels, ckpt_lib, cfg, depths, tmp, card, bf16_step_ms):
    """Phase 14: `device_data_cache: true` through `pggan_tpu_torch.train.main`
    from phase 12's folder: the batches against the host pipeline's (byte
    for byte unaugmented; augmented against the same assembly on the CPU),
    the launches, SIGTERM and the resume, the assembly's rates and the
    lazy-R1/16 window's imgs_per_sec with the cache, the host pipeline and
    synthetic data."""
    from pggan_tpu_torch.data.dataset import ImageFolderDataset
    from pggan_tpu_torch.data.device_cache import DeviceDataCache

    t_phase = time.perf_counter()
    _, _, _, start = train_checkpoint(ckpt_lib, cfg, depths, tmp)
    images = os.path.join(tmp, "images")
    write_image_folder(images)
    # cycles beyond the runs; a value equal to its default would not count as
    # set and the checkpoint's (ckpt_cycle 2) would win on resume
    base = {"save_root": tmp, "data_backend": "folder", "dataset_root_list": [images],
            "batch_per_gpu": BATCH, "num_data_workers": 8, "prefetch_depth": 2,
            "loss_cycle": 2, "test_cycle": NEVER, "ckpt_cycle": NEVER}

    def run(name, steps, over, *extra, ckpt_id="smoke_init", hook=None, end=None):
        config = os.path.join(tmp, f"{name}.yaml")
        with open(config, "w") as f:                # JSON is YAML
            json.dump(dict(base, **over), f)
        end = start + steps if end is None else end
        return folder_run(train_mod, kernels, [
            name, "--config", config, "--ckpt_id", ckpt_id, "--max_step", str(end),
            "--compute_dtype", "bfloat16", "--device", DEVICE, *extra], hook)

    def cache_line(lines):
        found = [line for line in lines if "device data cache:" in line]
        check(len(found) == 1 and f"{FOLDER_IMAGES} images" in found[0],
              f"device data cache lines {found}")
        return found[0]

    def check_batches(batches, n):
        check(len(batches) == n, f"{len(batches)} batches reached the step")
        for b in batches:
            check(b.dtype == torch.uint8 and tuple(b.shape) == (BATCH, RES, RES, 3)
                  and b.device.type == torch.device(DEVICE).type,
                  f"batch {b.dtype} {tuple(b.shape)} {b.device}")

    # unaugmented: the cache's batches are the host pipeline's
    rc, cached, _, lines, launches, seconds = run("cache_plain", CACHE_STEPS,
                                                  {"device_data_cache": True, "augment": False})
    check(rc == 0, f"the cache run returned {rc}")
    line = cache_line(lines)
    check_batches(cached, CACHE_STEPS)
    want = {k: n * CACHE_STEPS for k, n in STEP_LAUNCHES.items()}
    check(launches == want, f"launches {launches}, expected {want}")
    rc, hosted, _, lines, _, _ = run("host_plain", CACHE_STEPS, {"augment": False})
    check(rc == 0 and not any("device data cache:" in x for x in lines), f"host run {rc}")
    check(all(torch.equal(a, b) for a, b in zip(cached, hosted)),
          "unaugmented cache batches differ from the host pipeline's")
    print(f"[14 cache] pggan_tpu_torch.train.main with device_data_cache: true, augment: false, "
          f"{CACHE_STEPS} bf16 r1 steps at {RES}x{RES}, batch {BATCH}, from the scale-{SCALE} "
          f"checkpoint at step {start} in {seconds:.2f} s: {line!r}; every batch uint8 "
          f"[{BATCH},{RES},{RES},3] on {cached[0].device}, equal byte for byte to the host "
          f"pipeline's; launches {launches} = {CACHE_STEPS} steps x phase 8's")

    # augmented: the card's assembly against the CPU's and against the PIL path
    calls = []
    with recording_assembles(calls):
        rc, batches, _, lines, _, _ = run("cache_aug", FOLDER_STEPS, {"device_data_cache": True})
    check(rc == 0, f"the augmented cache run returned {rc}")
    cache_line(lines)
    check_batches(batches, FOLDER_STEPS)
    on_cpu = DeviceDataCache(ImageFolderDataset([images], SCALE), "cpu")
    dataset = ImageFolderDataset([images], SCALE, use_native=False)
    worst, mean, pil_worst, pil_mean = 0, 0.0, 0, 0.0
    for batch, (idxs, seeds) in zip(batches, calls):
        got = batch.cpu().numpy().astype(int)
        want = on_cpu.assemble(idxs, seeds).numpy().astype(int)
        pil = np.stack([dataset.get(int(i), np.random.RandomState(int(s)))
                        for i, s in zip(idxs, seeds)]).astype(int)
        worst, mean = max(worst, int(np.abs(got - want).max())), mean + np.abs(got - want).mean()
        pil_worst = max(pil_worst, int(np.abs(got - pil).max()))
        pil_mean += np.abs(got - pil).mean()
    mean, pil_mean = mean / len(batches), pil_mean / len(batches)
    check(worst <= ASSEMBLE_LSB and mean < ASSEMBLE_MEAN,
          f"augmented batches on the card vs the CPU's assembly: max {worst}, mean {mean:.4g}")
    print(f"[14 cache] augmented, {FOLDER_STEPS} steps: the card's batches against the same "
          f"draws assembled on the CPU max |diff| {worst} (bound {ASSEMBLE_LSB}), mean "
          f"{mean:.4g} (bound {ASSEMBLE_MEAN}); against the PIL path's max {pil_worst}, mean "
          f"{pil_mean:.4g} (8-bit rounding between its ops; not bounded)")

    # SIGTERM after a step, then the resume, with the cache
    cut = start + SIGTERM_AFTER

    def sigterm(trainer):
        if trainer.global_step == cut:
            os.kill(os.getpid(), signal.SIGTERM)
    handler = signal.getsignal(signal.SIGTERM)
    rc, _, _, lines, _, _ = run("cut_cache", FOLDER_STEPS, {"device_data_cache": True},
                                hook=sigterm)
    check(rc == 0 and signal.getsignal(signal.SIGTERM) is handler
          and any(f"interrupted at step {cut + 1}" in x for x in lines),
          f"the interrupted run returned {rc}")
    rc, resumed, _, lines, _, _ = run("cut_cache", 0, {"device_data_cache": True},
                                      ckpt_id="cut_cache", end=cut + 3)
    check(rc == 0 and any(f"checkpoint cut_cache@{cut + 1} restored" in x for x in lines),
          f"the resumed run returned {rc}")
    cache_line(lines)
    check(torch.equal(resumed[0], batches[SIGTERM_AFTER + 1]),
          "the resume's first batch differs from the uninterrupted run's")
    print(f"[14 sigterm] SIGTERM after step {cut} with the cache: checkpoint at {cut + 1}, clean "
          f"return; the resume rebuilt the cache, started at {cut + 1}, and its first batch "
          f"equals the uninterrupted run's at {cut + 1} byte for byte")

    call_rate = time_assembly(images, card, bf16_step_ms)

    # lazy R1/16: loss lines every LAZY_R1 steps, imgs_per_sec between them
    first = -(-start // LAZY_R1) * LAZY_R1
    end = first + LAZY_R1 * LAZY_WINDOWS + 1
    lazy = {"r1_interval": LAZY_R1, "loss_cycle": LAZY_R1}
    rates = {}
    for name, over, extra in (("lazy_cache", {"device_data_cache": True}, ()),
                              ("lazy_host", {}, ()),
                              ("lazy_synthetic", {}, ("--data_backend", "synthetic"))):
        trainers = []
        with recording_trainers(train_mod, trainers):
            rc, batches, _, _, launches, _ = run(name, 0, dict(lazy, **over), *extra, end=end)
        check(rc == 0, f"{name} returned {rc}")
        check_lazy_launches(f"14 {name}", launches, trainers[-1], len(batches))
        with open(os.path.join(tmp, name, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        check([m["step"] for m in lines] == list(range(first, end, LAZY_R1)),
              f"{name}: loss lines at {[m['step'] for m in lines]}")
        # the first line's rate counts from fit()'s start: left out
        rates[name] = [m["imgs_per_sec"] for m in lines[1:]]
    synth = np.mean(rates["lazy_synthetic"])
    print(f"[14 rates] card: {card}")
    print(f"[14 rates] lazy R1/{LAZY_R1} (r1_interval {LAZY_R1}, a loss line every {LAZY_R1} "
          f"steps: per span one logged R1 step and a window of {LAZY_R1 - 1} led by R1), bf16, "
          f"{RES}x{RES}, batch {BATCH}, trainer imgs_per_sec over steps {first}-{end - 1}: "
          + "; ".join(f"{name[5:]} {r} (mean {np.mean(r):.1f} = "
                      f"{100 * (np.mean(r) / synth - 1):+.1f} % of synthetic)"
                      for name, r in rates.items()))
    tail = BATCH / bf16_step_ms[False] * 1e3
    print(f"[14 rates] the cache keeps up with the bf16 step without R1 ({tail:.1f} img/s, "
          f"phase 10): {'yes' if call_rate >= tail else 'no'} ({call_rate / tail:.2f}x)")
    print(f"[14 cache] phase 14 took {time.perf_counter() - t_phase:.2f} s")


# ---- phase 15: the serving artifact ------------------------------------------

SERVE_CHILD = """
import json, sys, time
import numpy as np, torch
sys.path.insert(0, {repo!r})
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from pggan_tpu_torch.ops import kernels
t0 = time.perf_counter()
module = torch.export.load({path!r}).module()
load_s = time.perf_counter() - t0
launches, out = {{}}, {{}}
for b in {batches!r}:
    z = torch.from_numpy(np.random.RandomState(b).randn(b, {latent}).astype(np.float32))
    kernels.reset_launch_counts()
    with torch.no_grad():
        out[f"b{{b}}"] = module(z.to({device!r})).cpu().numpy()
    launches[b] = {{k: v for k, v in kernels.launches.items() if v}}
np.savez({result!r}, **out)
print(json.dumps({{"load_s": load_s, "launches": launches}}))
"""


def artifact_launches(kernels, forward):
    """forward()'s output and the kernel launches it made."""
    kernels.reset_launch_counts()
    with torch.no_grad():
        y = forward()
    torch.cuda.synchronize()
    return y, {k: v for k, v in kernels.launches.items() if v}


def run_serving(demo, kernels, cfg, depths, tmp, card):
    """Phase 15: `pggan_tpu_torch.demo --export` on phase 4's checkpoint, the
    artifact served in a fresh process at several batches against the eager
    G, in bf16 in process, exported on the CPU and served on the card, and
    tools/bench_serving_torch.py in both modes."""
    from pggan_tpu_torch import export as export_mod
    from pggan_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    latent = int(cfg.latent_dim)
    arrays = numpy_generator_arrays(1234, latent, depths, SCALE)
    ckpt_lib.save_checkpoint(tmp, "smoke", "G", 0, params=arrays, meta={
        "args": cfg.to_dict(), "schedule": {"scale_index": SCALE, "alpha": ALPHA}})
    path = os.path.join(tmp, "g.pt2")
    forward = SERVE_LAUNCHES
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = demo.main(["--ckpt_id", "smoke", "--save_root", tmp, "--device", DEVICE,
                        "--n_samples", str(BATCH), "--batch_size", str(BATCH),
                        "--output_dir", os.path.join(tmp, "samples"), "--export", path])
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.launches.items() if v}
    check(rc == 0 and os.path.exists(path), f"demo --export returned {rc}")
    check(launches == forward, f"demo --export launches {launches}: expected one forward's "
                               f"{forward} (tracing the export launches nothing)")
    size_mb = os.path.getsize(path) / 1e6
    print(f"[15 export] python -m pggan_tpu_torch.demo --export: "
          f"{' | '.join(out.getvalue().strip().splitlines())}; "
          f"{size_mb:.2f} MB; the demo with the export and {BATCH} samples took {demo_s:.2f} s; "
          f"launches {launches} (the sampling forward only)")

    # the artifact in a fresh process, against the eager G (f32, TF32 off)
    generator, _, _, alpha = demo.load_generator(tmp, "smoke", device=DEVICE)
    result = os.path.join(tmp, "served.npz")
    child = SERVE_CHILD.format(repo=REPO, path=path, batches=SERVE_BATCHES, latent=latent,
                               device=DEVICE, result=result)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                          timeout=600)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the serving process failed: {proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    served = np.load(result)
    errs = {}
    for b in SERVE_BATCHES:
        z = torch.from_numpy(np.random.RandomState(b).randn(b, latent).astype(np.float32))
        with torch.no_grad():
            want = generator(z.to(DEVICE), alpha).cpu().numpy()
        got = served[f"b{b}"]
        check(got.shape == (b, RES, RES, 3) and np.isfinite(got).all(), f"batch {b}: {got.shape}")
        errs[b] = float(np.abs(got - want).max())
        check(errs[b] <= SERVE_ATOL, f"batch {b}: artifact vs eager max |diff| {errs[b]:.3g}")
        check(report["launches"][str(b)] == forward,
              f"batch {b}: launches {report['launches'][str(b)]}, expected {forward}")
    print(f"[15 serve] a fresh process (importing pggan_tpu_torch.ops.kernels only) loaded the "
          f"artifact in {report['load_s']:.2f} s and sampled batches {list(SERVE_BATCHES)} "
          f"({child_s:.1f} s with its start); f32 TF32 off against the eager G: max |diff| "
          + ", ".join(f"b{b} {e:.3g}" for b, e in errs.items())
          + f" (bound {SERVE_ATOL}); launches per forward {report['launches']} ({card})")

    # in process: the f32 artifact's launches, the bf16 artifact against the eager bf16 G
    z = torch.from_numpy(np.random.RandomState(7).randn(BATCH, latent).astype(np.float32))
    z = z.to(DEVICE)
    _, f32_launches = artifact_launches(
        kernels, functools.partial(export_mod.load_exported(path).module(), z))
    check(f32_launches == forward, f"f32 artifact launches {f32_launches}")
    blob = export_mod.export_generator(generator, latent_dim=latent, alpha=alpha,
                                       compute_dtype=torch.bfloat16, device=DEVICE)
    bf16_module = functools.partial(export_mod.load_exported(blob).module(), z)
    got, bf16_launches = artifact_launches(kernels, bf16_module)
    with torch.no_grad():
        want = generator(z, alpha, compute_dtype=torch.bfloat16)
    check(got.dtype == torch.bfloat16 and bf16_launches == forward,
          f"bf16 artifact {got.dtype}, launches {bf16_launches}")
    gf, wf = got.float(), want.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(gf.abs(), wf.abs())
    bf16_err = float((gf - wf).abs().max())
    check(bool(((gf - wf).abs() <= ulp).all()), f"bf16 artifact vs eager: max |diff| {bf16_err}")
    print(f"[15 serve] bf16 artifact (exported in process) vs the eager bf16 G, batch {BATCH}: "
          f"max |diff| {bf16_err:.3g}, within one bf16 step everywhere; launches per forward "
          f"{bf16_launches} (f32 artifact {f32_launches})")
    with torch.no_grad():
        direct_ms, artifact_ms = abba_ms(
            lambda: generator(z, alpha, compute_dtype=torch.bfloat16), bf16_module)
    print(f"[15 serve] the same process, bf16, batch {BATCH}, in (direct, artifact, artifact, "
          f"direct) turns: eager G {direct_ms:.3f} ms = {BATCH / direct_ms * 1e3:.1f} img/s, "
          f"artifact {artifact_ms:.3f} ms = {BATCH / artifact_ms * 1e3:.1f} img/s "
          f"({direct_ms / artifact_ms:.3f}x; CUDA events over 20 calls each) ({card})")

    # exported on the CPU, served on the card
    t0 = time.perf_counter()
    cpu_blob = export_mod.export_generator(arrays, latent_dim=latent, alpha=alpha, device="cpu")
    cpu_export_s = time.perf_counter() - t0
    moved = export_mod.load_exported(cpu_blob, device=DEVICE)
    got, moved_launches = artifact_launches(kernels, functools.partial(moved.module(), z))
    with torch.no_grad():
        want = generator(z, alpha)
    moved_err = float((got - want).abs().max())
    check(got.device.type == torch.device(DEVICE).type and moved_launches == forward
          and moved_err <= SERVE_ATOL, f"the CPU-exported artifact on the card: {got.device}, "
                                       f"launches {moved_launches}, max |diff| {moved_err:.3g}")
    print(f"[15 serve] exported on the CPU in {cpu_export_s:.2f} s, moved to the card by "
          f"load_exported(device={DEVICE!r}): max |diff| {moved_err:.3g} against the eager G "
          f"(bound {SERVE_ATOL}), launches {moved_launches}")

    # the serving bench, both modes
    rows = {}
    for mode in ("direct", "artifact"):
        proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "bench_serving_torch.py"),
                               "--mode", mode, "--scale", str(SCALE), "--batch", str(BATCH),
                               "--compute_dtype", "bfloat16"],
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"bench_serving_torch --mode {mode}: {proc.stderr[-3000:]}")
        rows[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
        check(rows[mode]["launches_per_forward"] == forward, f"{mode}: {rows[mode]}")
        print(f"[15 bench] {json.dumps(rows[mode])}")
    ratio = rows["artifact"]["value"] / rows["direct"]["value"]
    print(f"[15 bench] artifact / direct device img/s {ratio:.3f}, e2e "
          f"{rows['artifact']['e2e_img_s'] / rows['direct']['e2e_img_s']:.3f} ({card})")
    print(f"[15 export] phase 15 took {time.perf_counter() - t_phase:.2f} s")


# ---- phase 16: a reference (PyTorch) checkpoint imported at full width ----

def reference_state_dicts(seed, latent_dim, depths, scale):
    """G's and D's state_dicts under the reference's key names
    (`pggan/nets.py`, `lib/blocks.py`), in its layouts (OIHW, [out, in]),
    drawn with numpy: N(0, 1) weights, U(±1/sqrt(fan_in)) biases. G's block
    convs sit at Sequential indices {0, 3} (PixelNorm modules between), the
    blocks of REF_PLAIN_BLOCKS at {0, 2}; D's at {0, 2}."""
    rng = np.random.default_rng(seed)

    def layer(sd, prefix, shape):
        bound = 1.0 / math.sqrt(int(np.prod(shape[1:])))
        sd[f"{prefix}.weight"] = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        sd[f"{prefix}.bias"] = torch.from_numpy(
            rng.uniform(-bound, bound, shape[0]).astype(np.float32))

    sd_g, sd_d, d0 = {}, {}, depths[0]
    layer(sd_g, "latent_format_layer.module", (16 * d0, latent_dim))
    layer(sd_g, "first_block.block.0.module", (d0, d0, 3, 3))
    for i in range(scale):
        second = 2 if i in REF_PLAIN_BLOCKS else 3
        layer(sd_g, f"blocks.{i}.block.0.module", (depths[i + 1], depths[i], 3, 3))
        layer(sd_g, f"blocks.{i}.block.{second}.module", (depths[i + 1], depths[i + 1], 3, 3))
    for i in range(scale + 1):
        layer(sd_g, f"toRGB_blocks.{i}.toRGB.module", (3, depths[i], 1, 1))
    layer(sd_d, "decision_layer.module", (1, d0))
    layer(sd_d, "minibatch_normalization_block.conv.module", (d0, d0 + 1, 3, 3))
    layer(sd_d, "minibatch_normalization_block.linear.module", (d0, 16 * d0))
    for i in range(scale):
        layer(sd_d, f"blocks.{i}.block.0.module", (depths[i + 1], depths[i + 1], 3, 3))
        layer(sd_d, f"blocks.{i}.block.2.module", (depths[i], depths[i + 1], 3, 3))
    for i in range(scale + 1):
        layer(sd_d, f"fromRGB_blocks.{i}.fromRGB.module", (depths[i], 3, 1, 1))
    return sd_g, sd_d


def reference_generator_forward(sd, z, alpha, scale, slope=0.2):
    """The reference `Generator.forward` (`pggan/nets.py:121-161`, PixelNorm
    on, no last activation) written straight from its state_dict with
    F.linear / F.conv2d: each layer's weight and bias times its He constant
    sqrt(2 / fan_in); a block's convs in the Sequential order of its keys.
    NCHW f32."""
    def eq(prefix, x, op, **kw):
        w, b = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
        c = math.sqrt(2.0 / w[0].numel())
        return op(x, w * c, b * c, **kw)

    def pn(x):
        return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)

    def act(x):
        return pn(F.leaky_relu(x, slope))

    def up(x):
        return F.interpolate(x, scale_factor=2, mode="nearest")

    x = F.leaky_relu(eq("latent_format_layer.module", pn(z), F.linear), slope)
    x = act(eq("first_block.block.0.module", pn(x.view(x.shape[0], -1, 4, 4)), F.conv2d,
               padding=1))
    prev = x
    for i in range(scale):
        prev, x = x, up(x)
        for j in sorted(int(k.split(".")[3]) for k in sd
                        if k.startswith(f"blocks.{i}.") and k.endswith(".weight")):
            x = act(eq(f"blocks.{i}.block.{j}.module", x, F.conv2d, padding=1))
    out = eq(f"toRGB_blocks.{scale}.toRGB.module", x, F.conv2d)
    if scale:
        low = up(eq(f"toRGB_blocks.{scale - 1}.toRGB.module", prev, F.conv2d))
        out = (1.0 - alpha) * low + alpha * out
    return out


def run_reference_import(demo, kernels, cfg, depths, tmp):
    """Phase 16: reference-format `G_*.pt` / `D_*.pt` at scale 6, full width
    (schedule scalars at alpha 0.5, an `args` dict with a key the port does
    not have), imported by `python -m pggan_tpu_torch.import_ckpt` into the
    run "imported", sampled by `pggan_tpu_torch.demo` (2 × BATCH images,
    launches checked), and the imported G (kernel path, f32, TF32 off)
    against `reference_generator_forward` of the same state_dict on one
    latent batch from a generator of the phase's own (seed 0). Returns the
    import's step (phase 17 resumes it)."""
    latent = int(cfg.latent_dim)
    t_phase = time.perf_counter()
    sd_g, sd_d = reference_state_dicts(5678, latent, depths, SCALE)
    args, start, schedule = train_args(cfg, tmp)
    common = {"args": dict(args, reference_only_key=True), "global_step": start,
              "alpha_G": schedule["alpha"], "alpha_D": schedule["alpha"],
              "alpha_index": schedule["alpha_index"],
              "alpha_jump_value": schedule["alpha_jump_value"],
              "next_alpha_jump_step": schedule["next_alpha_jump_step"],
              "scale_index": SCALE, "next_scale_jump_step": schedule["next_scale_jump_step"]}
    paths = {}
    for name, sd in (("G", sd_g), ("D", sd_d)):
        paths[name] = os.path.join(tmp, f"{name}_{start}.pt")
        torch.save({**common, "model": sd, "optimizer": {}}, paths[name])
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "pggan_tpu_torch.import_ckpt", "--g",
                           paths["G"], "--d", paths["D"], "--run_id", "imported",
                           "--save_root", tmp], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    import_s = time.perf_counter() - t0
    for line in (done.stdout + done.stderr).splitlines():
        print(f"[16 import]   {line}")
    check(done.returncode == 0, f"import_ckpt returned {done.returncode}")
    print(f"[16 import] python -m pggan_tpu_torch.import_ckpt: reference G and D "
          f"({sum(v.numel() for v in sd_g.values()) / 1e6:.2f} M and "
          f"{sum(v.numel() for v in sd_d.values()) / 1e6:.2f} M f32 parameters, G blocks "
          f"{list(REF_PLAIN_BLOCKS)} without PixelNorm indices) at scale {SCALE} imported in "
          f"{import_s:.2f} s (a fresh process: start-up, torch.load, conversion, npz writes)")

    launches, files, demo_s = sample_demo(demo, kernels, tmp, "imported")
    print(f"[16 import] pggan_tpu_torch.demo on the import: {len(files)} JPEGs of 256x256 "
          f"in {demo_s:.2f} s; launches {launches} = {len(files) // BATCH} forwards x (2, 13)")
    G, g_args, scale, alpha = demo.load_generator(tmp, "imported", device=DEVICE)
    check((scale, alpha) == (SCALE, ALPHA), f"imported schedule {scale}, {alpha}")
    check(g_args.generator_last_activation in (None, "", "none", "linear"),
          f"last activation {g_args.generator_last_activation!r}")
    z = torch.randn((BATCH, latent), generator=torch.Generator(device=DEVICE).manual_seed(0),
                    device=DEVICE)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = G(z, alpha)
        per_forward = {k: v for k, v in kernels.launches.items() if v}
        ref = reference_generator_forward({k: v.to(DEVICE) for k, v in sd_g.items()}, z,
                                          alpha, SCALE).permute(0, 2, 3, 1)
    check(per_forward == SERVE_LAUNCHES, f"launches of one forward {per_forward}")
    err, largest = float((out - ref).abs().max()), float(ref.abs().max())
    check(tuple(out.shape) == (BATCH, RES, RES, 3) and bool(torch.isfinite(out).all()),
          f"imported G output {tuple(out.shape)}")
    check(err <= IMPORT_RTOL * largest, f"imported G vs the reference forward: max |diff| "
                                        f"{err:.3g}, largest output {largest:.3g}")
    print(f"[16 import] imported G (kernel path, f32, TF32 off) vs the reference forward "
          f"of the state_dict (F.linear / F.conv2d, He constants): max |diff| {err:.3g} = "
          f"{err / largest:.3g} of the largest output {largest:.3g} (bound {IMPORT_RTOL}); "
          f"launches a forward {per_forward}")
    print(f"[16 import] phase 16 took {time.perf_counter() - t_phase:.2f} s")
    return start


# ---- phase 17: the data-parallel path on the one card ----

def free_port() -> int:
    import socket
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


@contextlib.contextmanager
def torchrun_vars():
    """torchrun's variables for rank 0 of a group of 1 on a free port."""
    with mock.patch.dict(os.environ, {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                                      "MASTER_ADDR": "127.0.0.1",
                                      "MASTER_PORT": str(free_port())}):
        yield


def dp_child(argv, label):
    """A data-parallel training process (torchrun or the spawn route), its
    output printed; returns (output lines, seconds)."""
    t0 = time.perf_counter()
    done = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    lines = (done.stdout + done.stderr).splitlines()
    for line in lines:
        print(f"[17 dp]   {line}")
    check(done.returncode == 0, f"{label} returned {done.returncode}")
    return lines, seconds


def check_dp_run(lines, ckpt_lib, tmp, run, start, steps, label):
    group = ("process group: nccl, world 1, rank 0, device cuda:0" if DEVICE == "cuda" else
             "process group: gloo, world 1, rank 0, device cpu")
    check(any(group in line for line in lines), f"{label}: no line {group!r}")
    losses = [line for line in lines if line.startswith("lossD:")]
    check(len(losses) == steps, f"{label}: {len(losses)} loss lines")
    for line in losses:
        d, g = line.replace("lossD:", "").split("| lossG:")
        check(np.isfinite(float(d)) and np.isfinite(float(g)), f"loss line {line!r}")
    ckpt_steps = sorted(int(f.split("_")[1][:-4]) for f in os.listdir(
        ckpt_lib.ckpt_dir(tmp, run)) if f.startswith("G_") and "latest" not in f)
    want = list(range(start + 2, start + steps, 2)) + [start + steps]
    check(ckpt_steps == want, f"{label}: checkpoint steps {ckpt_steps}, expected {want}")
    return ckpt_steps


def run_data_parallel(train_mod, kernels, ckpt_lib, tmp, start):
    """Phase 17a-c: `--use_mGPU` through torchrun (a child process), the
    spawn route (a child process) and in this process under torchrun's
    variables, each resuming phase 16's import for bf16 r1 steps at batch
    BATCH on synthetic data with a checkpoint every 2 steps. Returns (the
    launches of the in-process run, the ranks of the spawn route)."""
    t_phase = time.perf_counter()
    config = os.path.join(tmp, "dp.yaml")
    with open(config, "w") as f:
        json.dump({"save_root": tmp}, f)            # JSON is YAML
    base = ["--config", config, "--ckpt_id", "imported", "--compute_dtype", "bfloat16",
            "--device", DEVICE, "--use_mGPU"]
    end = str(start + DP_STEPS)
    lines, torchrun_s = dp_child(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "1", "-m", "pggan_tpu_torch.train", "dp_torchrun", "--max_step", end, *base],
        "torchrun")
    ckpts = check_dp_run(lines, ckpt_lib, tmp, "dp_torchrun", start, DP_STEPS, "torchrun")
    print(f"[17 dp] torchrun --nproc_per_node 1 -m pggan_tpu_torch.train --use_mGPU: an "
          f"NCCL group of world 1 on cuda:0, {DP_STEPS} bf16 r1 steps from the import, "
          f"checkpoints by rank 0 at {ckpts}, in {torchrun_s:.2f} s (a fresh process)")

    lines, spawn_s = dp_child([sys.executable, "-m", "pggan_tpu_torch.train", "dp_spawn",
                               "--max_step", str(start + SPAWN_STEPS), *base], "spawn route")
    world = torch.cuda.device_count()
    check(any(f"spawning {world} ranks" in line for line in lines), "no spawn line")
    check_dp_run(lines, ckpt_lib, tmp, "dp_spawn", start, SPAWN_STEPS, "spawn route")
    print(f"[17 dp] the spawn route (--use_mGPU without torchrun): {world} rank(s), "
          f"{SPAWN_STEPS} steps in {spawn_s:.2f} s")

    out = io.StringIO()
    with torchrun_vars():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train_mod.main(["dp_inproc", "--max_step", end, *base])
        torch.cuda.synchronize()
        inproc_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
    lines = out.getvalue().splitlines()
    check(rc == 0, f"in-process data-parallel main returned {rc}")
    check(not torch.distributed.is_initialized(), "main left its process group joined")
    check_dp_run(lines, ckpt_lib, tmp, "dp_inproc", start, DP_STEPS, "in-process")
    want = {k: n * DP_STEPS for k, n in STEP_LAUNCHES.items()}
    check(launches == want, f"data-parallel launches {launches}, expected {want}")
    print(f"[17 dp] in this process under torchrun's variables: the same group line and "
          f"checkpoints; launches {launches} = {DP_STEPS} steps x phase 8's {STEP_LAUNCHES}, "
          f"in {inproc_s:.2f} s")
    print(f"[17 dp] phase 17a-c took {time.perf_counter() - t_phase:.2f} s")
    return launches, world


def compare_dp_step(step_mod, equalized, mesh, cfg, arrays_g, arrays_d, gen):
    """Phase 17d: DP_COMPARE_STEPS f32 steps (TF32 off, cuDNN's deterministic
    algorithms) of the data-parallel step in a group of 1 (gradients through
    `mesh.all_reduce_mean_`: a flat copy, NCCL's one-rank all-reduce, a
    division by 1, the copy back) against the single-process step, from the
    same state, batches and latent generator: parameters and Adam's
    moments must agree bit for bit. Call inside a joined group."""
    batches = [torch.randint(0, 256, (BATCH, RES, RES, 3), generator=gen, device=DEVICE,
                             dtype=torch.uint8) for _ in range(DP_COMPARE_STEPS)]
    results = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, kw in (("single", {}), ("data-parallel", dict(
                grad_sync=mesh.all_reduce_mean_, rank=mesh.rank(),
                world_size=mesh.world_size()))):
            state = train_state(step_mod, cfg, arrays_g, arrays_d)
            step = step_mod.make_train_step(cfg, SCALE, **kw)
            for batch in batches:
                metrics, _ = step(state, batch, ALPHA)
            results[label] = ({k: float(v) for k, v in metrics.items()}, {
                f"{n}/{part}/{k}": v for n, net, opt in (("G", state.G, state.opt_G),
                                                         ("D", state.D, state.opt_D))
                for part, arrays in (("params", equalized.params_to_jax(net)),
                                     ("opt", equalized.adam_state_to_jax(opt, net)))
                for k, v in arrays.items()})
    finally:
        torch.backends.cudnn.deterministic = False
    (m_a, a), (m_b, b) = results["single"], results["data-parallel"]
    differ = sorted(k for k in a if not np.array_equal(a[k], b[k]))
    worst = max((float(np.abs(a[k] - b[k]).max()) for k in differ), default=0.0)
    print(f"[17 dp] f32 TF32 off, {DP_COMPARE_STEPS} r1 steps at {RES}x{RES} batch {BATCH}: "
          f"the data-parallel step (world {mesh.world_size()}) vs the single-process step: "
          f"{len(a) - len(differ)} of {len(a)} arrays (G and D parameters, Adam count, mu, "
          f"nu) bit for bit equal, largest |diff| {worst:.3g}; losses {m_b} vs {m_a}")
    check(not differ and m_a == m_b, f"the data-parallel step differs from the single-process "
                                     f"step in {differ[:6]}")


def time_data_parallel(step_mod, mesh, cfg, arrays_g, arrays_d, gen, card):
    """Phase 17e: the bf16 R1 step and the step without R1, with and without
    the gradient all-reduce (a group of 1), in (single, dp, dp, single)
    turns; `all_reduce_mean_` alone on G's and D's gradients (CUDA events,
    20 calls), and its NCCL call alone on the flat bucket. Call inside a
    joined group."""
    batch = torch.randint(0, 256, (BATCH, RES, RES, 3), generator=gen, device=DEVICE,
                          dtype=torch.uint8)
    run_cfg = copy.deepcopy(cfg)
    run_cfg["compute_dtype"] = "bfloat16"
    state = train_state(step_mod, run_cfg, arrays_g, arrays_d)
    sync = dict(grad_sync=mesh.all_reduce_mean_, rank=mesh.rank(), world_size=mesh.world_size())
    step_ms = {}
    for r1 in (True, False):
        steps = {"single": step_mod.make_train_step(run_cfg, SCALE, include_r1=r1),
                 "dp": step_mod.make_train_step(run_cfg, SCALE, include_r1=r1, **sync)}
        seen = collections.defaultdict(list)
        for label in ("single", "dp", "dp", "single"):
            for _ in range(2):
                steps[label](state, batch, ALPHA)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                steps[label](state, batch, ALPHA)
            torch.cuda.synchronize()
            seen[label].append((time.perf_counter() - t0) / 5 * 1e3)
        step_ms[r1] = {k: sum(v) / len(v) for k, v in seen.items()}
        kind = "R1" if r1 else "no R1"
        single, dp = step_ms[r1]["single"], step_ms[r1]["dp"]
        print(f"[17 times] bf16 {kind} step {RES}x{RES} batch {BATCH}: single process "
              f"{single:.2f} ms, data-parallel (world {mesh.world_size()}) {dp:.2f} ms "
              f"({100 * (dp / single - 1):+.2f} %); host clock over 5 steps after 2 "
              f"warm-up, turns single, dp, dp, single: "
              f"{ {k: [round(x, 2) for x in v] for k, v in seen.items()} } ({card})")
    total_ms, total_bytes = 0.0, 0
    for name, net in (("G", state.G), ("D", state.D)):
        grads = [torch.randn(p.shape, generator=gen, device=DEVICE) for p in net.parameters()]
        flat = torch.cat([g.reshape(-1) for g in grads])
        nbytes = flat.numel() * 4
        call = time_ms(lambda: mesh.all_reduce_mean_(grads))  # noqa: B023
        nccl = time_ms(lambda: torch.distributed.all_reduce(flat))  # noqa: B023
        total_ms, total_bytes = total_ms + call, total_bytes + nbytes
        print(f"[17 times] all_reduce_mean_ on {name}'s {len(grads)} gradients "
              f"({nbytes / 1e6:.1f} MB f32): {call:.4f} ms a call (flat copy, NCCL "
              f"all-reduce, division, copy back; CUDA events, 20 calls); the NCCL call alone "
              f"{nccl:.4f} ms ({card})")
    no_r1 = step_ms[False]["single"]
    print(f"[17 times] the two all-reduces of a step: {total_ms:.4f} ms for "
          f"{total_bytes / 1e6:.1f} MB of gradients = {100 * total_ms / no_r1:.2f} % of the "
          f"{no_r1:.2f} ms step without R1, {100 * total_ms / step_ms[True]['single']:.3f} % "
          f"of the R1 step ({card})")
    return step_ms, total_ms


def step_launches(scale):
    """Kernel launches of one r1 step at `scale`: phase 8's at scale 6, with
    the G epilogues (two convs a block) counted for `scale`'s blocks."""
    epilogues = 1 + 2 * scale
    return dict(STEP_LAUNCHES, lrelu_pixel_norm=2 * epilogues, lrelu_pixel_norm_bwd=epilogues)


def loader_env():
    """[18 env]: the compiler, libjpeg's and libpng's headers, and grain.
    Returns whether grain imports."""
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    headers = ", ".join(f"/usr/include/{h} {'present' if os.path.exists(f'/usr/include/{h}') else 'missing'}"
                        for h in ("jpeglib.h", "png.h"))
    try:
        import grain  # noqa: F401
        grain_ok = True
    except ImportError:
        grain_ok = False
    print(f"[18 env] {(gxx.stdout.splitlines() or ['g++: ' + gxx.stderr.strip()])[0]}; "
          f"{headers}; grain {'imports' if grain_ok else 'is not installed'}")
    return grain_ok


def build_loader():
    """[18 build]: the process's native loader, built at its first use (here
    or by phase 12's dataset) from pggan_tpu_torch/native/loader.cpp into
    pggan_tpu_torch/_build/; and the same library built again into an empty
    directory, timed. Returns its decoder ('native' or 'PIL')."""
    from pggan_tpu_torch.native import NativeImageLoader, build

    lib = build.get_loader_lib()
    check(lib is not None, "the native loader did not build")
    codecs = bool(lib.pggan_has_codecs())
    path = build.library_path(codecs)
    check(os.path.exists(path) and os.path.dirname(path) == os.path.join(
        REPO, "pggan_tpu_torch", "_build"), f"loader library {path}")
    with tempfile.TemporaryDirectory(prefix="pggan_loader_") as fresh, \
            mock.patch.object(build, "BUILD_DIR", fresh):
        t0 = time.perf_counter()
        build.build_library(codecs)
        seconds = time.perf_counter() - t0
    decoder = NativeImageLoader(4).decoder
    flags = build.FLAGS + (build.CODEC_LIBS if codecs else build.NO_CODECS)
    print(f"[18 build] {os.path.relpath(path, REPO)} from pggan_tpu_torch/native/loader.cpp; "
          f"a build into an empty directory took {seconds:.2f} s (g++ {' '.join(flags)}); "
          + ("libjpeg/libpng decode in C++" if codecs else
             "built without the codecs: PIL decodes, C++ resizes and jitters"))
    return decoder


def write_hires_folder(root, count=HIRES_IMAGES, seed=1024):
    """`count` JPEGs, alternately HIRES_SIDES[0]² and HIRES_SIDES[1]², in two
    subdirectories: a smooth colour field plus noise (write_image_folder's
    recipe)."""
    from PIL import Image
    rs = np.random.RandomState(seed)
    for i in range(count):
        side = HIRES_SIDES[i % 2]
        sub = os.path.join(root, f"part{i % 2}")
        os.makedirs(sub, exist_ok=True)
        low = Image.fromarray(rs.randint(0, 256, (12, 12, 3), dtype=np.uint8)).resize(
            (side, side), Image.BILINEAR)
        noise = rs.randint(-24, 25, (side, side, 3))
        arr = np.clip(np.asarray(low, np.int16) + noise, 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(sub, f"{i:03d}.jpg"), quality=90)


def pil_only():
    """Datasets built inside take the PIL path: the loader reads as not
    built (what `use_native=None` does where it does not build)."""
    from pggan_tpu_torch.native import build
    return mock.patch.object(build, "get_loader_lib", return_value=None)


def compare_loaders(folders, tmp):
    """[18 loader]: the backend for use_native None and True; native against
    PIL draws at 256² (phase 12's 320² folder and the high-resolution one)
    and 1024²; cached, stored and uncached native draws."""
    from pggan_tpu_torch.data.dataset import ImageFolderDataset

    for use_native in (None, True):
        ds = ImageFolderDataset([folders[256]], SCALE, use_native=use_native)
        check(ds.backend == "native", f"use_native={use_native}: backend {ds.backend}")
    rows = []
    for label, root, scale in (("320² → 256²", folders[256], 6),
                               ("1024²/1280² → 256²", folders[1024], 6),
                               ("1024²/1280² → 1024²", folders[1024], 8)):
        res = 4 * 2 ** scale
        picks = range(LOADER_DRAWS)
        native = ImageFolderDataset([root], scale, use_native=True, cache_decoded=True)
        pil = ImageFolderDataset([root], scale, use_native=False, cache_decoded=True)
        resize = max(int(np.abs(native.resized_array(i).astype(int)
                                - pil.resized_array(i).astype(int)).max()) for i in picks)
        aug = np.stack([np.abs(native.get(i, np.random.RandomState(i)).astype(int)
                               - pil.get(i, np.random.RandomState(i)).astype(int))
                        for i in picks])
        check(resize <= LOADER_RESIZE_LSB, f"{label}: native vs PIL resize max {resize}")
        tail = float(np.mean(aug > LOADER_AUG_LSB))
        check(tail <= LOADER_AUG_TAIL and aug.mean() <= LOADER_AUG_MEAN,
              f"{label}: native vs PIL augmented mean {aug.mean():.3f}, above "
              f"{LOADER_AUG_LSB} on {100 * tail:.4f} %")
        rows.append(f"{label} ({res}²): resize max {resize} (bound {LOADER_RESIZE_LSB}), "
                    f"augmented mean {aug.mean():.3f} (bound {LOADER_AUG_MEAN}), above "
                    f"{LOADER_AUG_LSB} on {100 * tail:.4f} % (bound {100 * LOADER_AUG_TAIL:g} "
                    f"%), max {aug.max()}")
    print(f"[18 loader] dataset backend 'native' for use_native None and True; native vs PIL "
          f"over {LOADER_DRAWS} images: " + "; ".join(rows))
    tiers = {}
    for res, scale in ((256, 6), (1024, 8)):
        cached = ImageFolderDataset([folders[1024]], scale, cache_decoded=True)
        stored = ImageFolderDataset([folders[1024]], scale, resized_store=True,
                                    store_dir=os.path.join(tmp, f"tier_store_{res}"))
        uncached = ImageFolderDataset([folders[1024]], scale, cache_decoded=False)
        worst, twos = 0, 0.0
        for i in range(LOADER_DRAWS):
            draws = [ds.get(i, np.random.RandomState(100 + i)).astype(int)
                     for ds in (cached, stored, uncached)]
            check(np.array_equal(draws[0], draws[1]), f"{res}²: stored draw {i} differs "
                                                      f"from the cached one")
            delta = np.abs(draws[0] - draws[2])
            worst, twos = max(worst, int(delta.max())), twos + float(np.mean(delta == 2))
        check(worst <= TIER_LSB, f"{res}²: cached vs uncached max {worst}")
        tiers[res] = (worst, twos / LOADER_DRAWS)
    print(f"[18 loader] native draws over {LOADER_DRAWS} images: stored = cached byte for "
          f"byte; cached vs uncached " + ", ".join(
              f"{res}² max {w} (bound {TIER_LSB}; 2 steps on {100 * s:.4f} % of values)"
              for res, (w, s) in tiers.items()))


def pipeline_rate(dataset, batch, workers, batches):
    """img/s of the pipeline alone onto the card (2 batches of prefetch)
    over `batches` batches after the first; checks the batches."""
    from pggan_tpu_torch.data.dataset import split_dataset
    from pggan_tpu_torch.data.pipeline import DataPipeline

    indices, _ = split_dataset(len(dataset))
    with DataPipeline(dataset, batch, indices=indices, num_workers=workers, prefetch_depth=2,
                      seed=0, device=DEVICE) as pipe:
        next(pipe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            out = next(pipe)
        torch.cuda.synchronize()
        rate = batches * batch / (time.perf_counter() - t0)
    res = dataset.resolution
    check(out.dtype == torch.uint8 and tuple(out.shape) == (batch, res, res, 3)
          and out.device.type == torch.device(DEVICE).type, f"pipeline batch {out.dtype} {tuple(out.shape)}")
    return rate


def time_loader_pipelines(folders, tmp, card):
    """[18 rates]: the pipeline alone, native and PIL, 8 and 1 workers, at
    256² (RAM cache, phase 12's folder) and 1024² (resized store), and
    native with 8 workers at 512² (resized store). Returns {res: native img/s
    with 8 workers}."""
    from pggan_tpu_torch.data.dataset import ImageFolderDataset

    rates, native8 = [], {}
    for res, scale, batch in ((256, 6, BATCH), (512, 7, 32), (1024, 8, 16)):
        loaders = ("native", "PIL") if res != 512 else ("native",)
        for loader in loaders:
            kw = (dict(cache_decoded=True) if res == 256 else
                  dict(resized_store=True, store_dir=os.path.join(tmp, f"store_{loader}")))
            with (pil_only() if loader == "PIL" else contextlib.nullcontext()):
                ds = ImageFolderDataset([folders[256 if res == 256 else 1024]], scale, **kw)
            check(ds.backend == loader, f"{res}²: backend {ds.backend}, expected {loader}")
            if res == 256:
                for i in range(len(ds)):        # the RAM cache filled, as after an epoch
                    ds.resized_array(i)
            for workers in ((8, 1) if res != 512 else (8,)):
                rate = pipeline_rate(ds, batch, workers, HIRES_RATE_BATCHES[res])
                if loader == "native" and workers == 8:
                    native8[res] = rate
                rates.append(f"{res}² {loader} {workers} worker(s) {rate:.1f} img/s")
    print(f"[18 rates] card: {card}")
    print(f"[18 rates] data pipeline alone onto the card (augmented, 2 batches of prefetch; "
          f"256² batch {BATCH} from the RAM cache, 512² batch 32 and 1024² batch 16 from the "
          f"resized store): " + "; ".join(rates))
    return native8


def time_loader_trainer(train_mod, kernels, ckpt_lib, cfg, depths, folders, tmp, card):
    """[18 rates]: the trainer's imgs_per_sec over lazy R1/16 at 256² (phase
    14's recipe, no device cache) with the native loader, PIL and
    synthetic data."""
    _, _, _, start = train_checkpoint(ckpt_lib, cfg, depths, tmp)
    base = {"save_root": tmp, "data_backend": "folder", "dataset_root_list": [folders[256]],
            "batch_per_gpu": BATCH, "num_data_workers": 8, "prefetch_depth": 2,
            "r1_interval": LAZY_R1, "loss_cycle": LAZY_R1, "test_cycle": NEVER,
            "ckpt_cycle": NEVER}
    first = -(-start // LAZY_R1) * LAZY_R1
    end = first + LAZY_R1 * LAZY_WINDOWS + 1
    rates = {}
    for name, loader, extra in (("lazy_native", "native loader", ()),
                                ("lazy_pil", "PIL loader", ()),
                                ("lazy_synth", None, ("--data_backend", "synthetic"))):
        config = os.path.join(tmp, f"{name}.yaml")
        with open(config, "w") as f:                    # JSON is YAML
            json.dump(base, f)
        trainers = []
        with (pil_only() if name == "lazy_pil" else contextlib.nullcontext()), \
                recording_trainers(train_mod, trainers):
            rc, batches, _, lines, launches, _ = folder_run(train_mod, kernels, [
                name, "--config", config, "--ckpt_id", "smoke_init", "--max_step", str(end),
                "--compute_dtype", "bfloat16", "--device", DEVICE, *extra])
        check(rc == 0, f"{name} returned {rc}")
        check_lazy_launches(f"18 {name}", launches, trainers[-1], len(batches))
        if loader:
            check(any(f"({loader}" in line for line in lines), f"{name}: no '{loader}' line")
        with open(os.path.join(tmp, name, "metrics.jsonl")) as f:
            steps_rates = [json.loads(line) for line in f]
        check([m["step"] for m in steps_rates] == list(range(first, end, LAZY_R1)),
              f"{name}: loss lines at {[m['step'] for m in steps_rates]}")
        rates[name[5:]] = [m["imgs_per_sec"] for m in steps_rates[1:]]
    synth = np.mean(rates["synth"])
    print(f"[18 rates] lazy R1/{LAZY_R1} through the trainer (phase 14's recipe, no device "
          f"cache), bf16, {RES}x{RES}, batch {BATCH}, imgs_per_sec over steps {first}-"
          f"{end - 1}: " + "; ".join(f"{k} {v} (mean {np.mean(v):.1f} = "
                                     f"{100 * (np.mean(v) / synth - 1):+.1f} % of synthetic)"
                                     for k, v in rates.items()) + f" ({card})")


def hires_checkpoint(ckpt_lib, cfg, scale, tmp, run_id):
    """A JAX-format G+D checkpoint of `cfg` (config_1024.yaml's model) at
    `scale`, numpy-seeded weights, fresh Adam; the schedule inside the
    scale at alpha 0.5 with no jump within the runs. Returns (G arrays, D
    arrays, start step)."""
    depths = [int(d) for d in cfg.depths]
    arrays_g = numpy_generator_arrays(1234 + scale, int(cfg.latent_dim), depths, scale)
    arrays_d = numpy_discriminator_arrays(4321 + scale, depths, scale)
    args = cfg.to_dict()
    args.update(save_root=tmp, use_mGPU=False)
    steps = [int(n) for n in args["max_step_at_scale"]]
    scale_end = sum(steps[:scale + 1])
    start = scale_end - steps[scale] + int(args["alpha_jump_start"][scale]) + 199 * 100 + 50
    schedule = {"scale_index": scale, "alpha": ALPHA, "alpha_index": 200,
                "alpha_jump_value": 1.0 / 400, "next_scale_jump_step": scale_end,
                "next_alpha_jump_step": start + 50}
    for name, arrays in (("G", arrays_g), ("D", arrays_d)):
        ckpt_lib.save_checkpoint(tmp, run_id, name, start, params=arrays,
                                 opt=fresh_adam_arrays(arrays),
                                 meta={"args": args, "schedule": schedule})
    return arrays_g, arrays_d, start


def run_hires_train(train_mod, kernels, ckpt_lib, cfg, folder, tmp):
    """[18 train]: `pggan_tpu_torch.train.main` on config_1024.yaml's keys at
    full width from the high-resolution folder through the native loader
    and the resized store, HIRES_STEPS bf16 r1 steps at scales 7 and 8.
    Returns {scale: (G arrays, D arrays)}."""
    import yaml

    with open(os.path.join(REPO, CONFIG_1024)) as f:
        keys = yaml.safe_load(f)
    keys.update(save_root=tmp, dataset_root_list=[folder], data_backend="folder",
                resized_store=True, resized_store_dir=os.path.join(tmp, "store"),
                loss_cycle=1, test_cycle=NEVER, ckpt_cycle=NEVER)
    config = os.path.join(tmp, "config_1024.yaml")
    with open(config, "w") as f:
        json.dump(keys, f)                          # JSON is YAML
    arrays = {}
    for scale in HIRES_SCALES:
        res, batch = 4 * 2 ** scale, int(cfg.batch_schedule[scale])
        arrays_g, arrays_d, start = hires_checkpoint(ckpt_lib, cfg, scale, tmp, f"init{scale}")
        arrays[scale] = (arrays_g, arrays_d)
        run, end = f"hires{scale}", start + HIRES_STEPS
        rc, batches, run_cfg, lines, launches, seconds = folder_run(train_mod, kernels, [
            run, "--config", config, "--ckpt_id", f"init{scale}", "--max_step", str(end),
            "--device", DEVICE, "--no_mGPU"])
        for line in lines:
            print(f"[18 train]   {line}")
        check(rc == 0, f"scale {scale}: train main returned {rc}")
        check(run_cfg["compute_dtype"] == "bfloat16" and run_cfg["loss_mode"] == "r1"
              and int(run_cfg["r1_interval"]) == 1, f"scale {scale}: run config")
        banner = [line for line in lines if "images constructed for the training" in line]
        check(len(banner) == 1 and "(native loader" in banner[0] and "resized store" in
              banner[0], f"scale {scale}: dataset lines {banner}")
        check(len(batches) == HIRES_STEPS, f"scale {scale}: {len(batches)} batches")
        for b in batches:
            check(b.dtype == torch.uint8 and tuple(b.shape) == (batch, res, res, 3)
                  and b.device.type == torch.device(DEVICE).type,
                  f"batch {b.dtype} {tuple(b.shape)} {b.device}")
        want = {k: n * HIRES_STEPS for k, n in step_launches(scale).items()}
        check(launches == want, f"scale {scale}: launches {launches}, expected {want}")
        losses = [line for line in lines if line.startswith("lossD:")]
        check(len(losses) == HIRES_STEPS, f"scale {scale}: {len(losses)} loss lines")
        for line in losses:
            d, g = line.replace("lossD:", "").split("| lossG:")
            check(np.isfinite(float(d)) and np.isfinite(float(g)), f"loss line {line!r}")
        for name, before in (("G", arrays_g), ("D", arrays_d)):
            params, opt, meta = ckpt_lib.load_checkpoint(tmp, run, name, end)
            check(set(params) == set(before) and int(opt["0/count"]) == HIRES_STEPS
                  and meta["schedule"]["scale_index"] == scale,
                  f"scale {scale}: {name} checkpoint at {end}")
        print(f"[18 train] config_1024.yaml through pggan_tpu_torch.train.main --no_mGPU: "
              f"scale {scale} ({res}x{res}), batch {batch}, bf16, r1 every step, "
              f"{HIRES_STEPS} steps from step {start} in {seconds:.2f} s (checkpoint load, "
              f"resized store, steps, checkpoint); every batch uint8 [{batch},{res},{res},3] "
              f"on {batches[0].device}; launches {launches} = {HIRES_STEPS} x "
              f"{step_launches(scale)}; losses finite; rank 0's checkpoint at {end} reloads "
              f"with Adam count {HIRES_STEPS}")
    return arrays


def time_hires_steps(step_mod, cfg, arrays, native8, gen, card):
    """[18 times]: step ms, img/s and peak memory at scales 7 and 8, bf16,
    with and without R1, and whether the native pipeline keeps up; f32 with
    TF32 off with R1 at scale 8 where 3.4x the bf16 peak (256²'s ratio,
    phase 10) fits. Returns the scale-8 bf16 state and batch."""
    for scale in HIRES_SCALES:
        res, batch = 4 * 2 ** scale, int(cfg.batch_schedule[scale])
        run_cfg = copy.deepcopy(cfg)
        run_cfg.update(batch_per_gpu=batch, compute_dtype="bfloat16")
        state = train_state(step_mod, run_cfg, *arrays[scale])
        images = torch.randint(0, 256, (batch, res, res, 3), generator=gen, device=DEVICE,
                               dtype=torch.uint8)
        peaks = {}
        for r1 in (True, False):
            step = step_mod.make_train_step(run_cfg, scale, include_r1=r1)
            for _ in range(2):
                step(state, images, ALPHA)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n = 4
            t0 = time.perf_counter()
            for _ in range(n):
                step(state, images, ALPHA)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / n * 1e3
            peaks[r1] = torch.cuda.max_memory_allocated() / 2 ** 20
            rate = batch / ms * 1e3
            print(f"[18 times] config_1024 step {res}x{res} batch {batch} bf16, "
                  f"{'R1' if r1 else 'no R1'}: {ms:.2f} ms = {rate:.1f} img/s; peak memory "
                  f"{peaks[r1]:.0f} MiB (host clock over {n} steps after 2 warm-up); the "
                  f"native pipeline alone {native8[res]:.1f} img/s keeps up: "
                  f"{'yes' if native8[res] >= rate else 'no'} ({native8[res] / rate:.2f}x) "
                  f"({card})")
    f32_mib = 3.4 * peaks[True]
    free = torch.cuda.mem_get_info()[1] / 2 ** 20
    if f32_mib < 0.85 * free:
        f32_cfg = copy.deepcopy(run_cfg)
        f32_cfg["compute_dtype"] = "float32"
        del state
        torch.cuda.empty_cache()
        f32_state = train_state(step_mod, f32_cfg, *arrays[8])
        step = step_mod.make_train_step(f32_cfg, 8, include_r1=True)
        step(f32_state, images, ALPHA)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(2):
            step(f32_state, images, ALPHA)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 2 * 1e3
        print(f"[18 times] config_1024 step 1024x1024 batch 16 f32 TF32 off, R1: {ms:.2f} ms "
              f"= {16 / ms * 1e3:.1f} img/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB (host clock over 2 "
              f"steps after 1 warm-up; predicted {f32_mib:.0f} MiB) ({card})")
        del f32_state
        torch.cuda.empty_cache()
        state = train_state(step_mod, run_cfg, *arrays[8])
    else:
        print(f"[18 times] f32 TF32 off at 1024x1024 not run: 3.4 x the bf16 R1 peak = "
              f"{f32_mib:.0f} MiB against {free:.0f} MiB on the card")
    return state, images, run_cfg


def time_hires_kernels(kernels, gen, card):
    """[18 kernels]: lrelu_pixel_norm's forward and backward against their
    plain versions at HIRES_KERNEL_SHAPES, f32 and bf16: max |diff|, call
    ms, device ms and the bound. Returns {(name, shape, dtype): (call ms,
    device ms, plain ms, bound ms)}."""
    times = {}
    for shape, dt in itertools.product(HIRES_KERNEL_SHAPES, (torch.float32, torch.bfloat16)):
        x, g = nhwc(shape, dt, gen), nhwc(shape, dt, gen)
        n, es = x.numel(), x.element_size()
        for name, kernel, plain, tol, nbytes, flops in (
                ("lrelu_pixel_norm", lambda: kernels.lrelu_pixel_norm(x),
                 lambda: kernels.lrelu_pixel_norm_plain(x), TOL[dt], 2 * n * es, 4 * n),
                ("lrelu_pixel_norm_bwd", lambda: kernels.lrelu_pixel_norm_bwd(x, g),
                 lambda: kernels.lrelu_pixel_norm_bwd_plain(x, g), BWD_TOL[dt],
                 3 * n * es, 12 * n)):
            with torch.no_grad():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **tol,
                                           msg=lambda m: f"{name} {list(shape)}: {m}")
                err = float((got.float() - want.float()).abs().max())
                del got, want
                plain_ms, kernel_ms = abba_ms(plain, kernel, iters=10)
                dev = device_ms(kernel, kernels, name, calls=HIRES_DEVICE_CALLS)
            b_ms, b_by = bound_ms(nbytes, flops)
            times[(name, shape, dt)] = (kernel_ms, dev, plain_ms, b_ms)
            print(f"[18 kernels] {name} {list(shape)} {str(dt)[6:]}: max |diff| to the plain "
                  f"version {err:.3g}; kernel call {kernel_ms:.4f} ms, device {dev:.4f} ms "
                  f"= {100 * b_ms / dev:.0f} % of the bound {b_ms:.4f} ms ({b_by}); plain "
                  f"call {plain_ms:.4f} ms ({card})")
        del x, g
        torch.cuda.empty_cache()
    return times


def profile_rows(run, steps=2):
    """`run` profiled over `steps` calls (torch.profiler, CPU and CUDA
    activities), as tools/profile_torch_step.py does. Returns (wall ms,
    busy ms, summed kernel ms, [(ms, calls, kernel name)] a call)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    rows = sorted(((us / 1e3 / steps, count // steps, name)
                   for name, (us, count) in by_name.items()), reverse=True)
    return wall_ms, busy_us / 1e3 / steps, sum(r[0] for r in rows), rows


def profile_hires_step(step_mod, cfg, state, images, card):
    """[18 profile]: the scale-8 bf16 step with and without R1 under
    torch.profiler: idle share, the top 8 kernels, the layout copies."""
    for r1 in (True, False):
        step = step_mod.make_train_step(cfg, 8, include_r1=r1)
        step(state, images, ALPHA)
        torch.cuda.synchronize()
        wall, busy, summed, rows = profile_rows(lambda: step(state, images, ALPHA))
        check(busy > 0 and rows, "the profile saw no device time")
        copies = [(ms, n, name) for ms, n, name in rows
                  if any(key.lower() in name.lower() for key in LAYOUT_COPY_NAMES)]
        copy_ms = sum(ms for ms, _, _ in copies)
        print(f"[18 profile] config_1024 step 1024x1024 batch {images.shape[0]} bf16 "
              f"{'with' if r1 else 'without'} R1 ({card}): wall {wall:.2f} ms/step under the "
              f"profiler; device busy {busy:.2f} ms/step (idle "
              f"{100 * max(0.0, 1 - busy / wall):.1f} %); kernel time summed {summed:.2f} "
              f"ms/step; layout copies {copy_ms:.2f} ms = {100 * copy_ms / summed:.1f} % "
              f"of it in {sum(n for _, n, _ in copies)} launches")
        for ms, count, name in rows[:8]:
            print(f"[18 profile]   {ms:9.3f} ms {100 * ms / summed:5.1f} % x{count:<4d} "
                  f"{name[:110]}")
        for ms, count, name in copies[:4]:
            print(f"[18 profile]   copy {ms:9.3f} ms {100 * ms / summed:5.1f} % x{count:<4d} "
                  f"{name[:100]}")


def run_grain_train(train_mod, kernels, ckpt_lib, cfg, depths, folder, tmp, card):
    """[18 grain]: GRAIN_STEPS steps with data_backend_impl: grain at 256²
    from phase 12's folder, the batches on the card, and grain's rate
    alone."""
    from pggan_tpu_torch.data.dataset import ImageFolderDataset, split_dataset
    from pggan_tpu_torch.data.grain_pipeline import GrainPipeline

    _, _, _, start = train_checkpoint(ckpt_lib, cfg, depths, tmp)
    config = os.path.join(tmp, "grain.yaml")
    with open(config, "w") as f:                    # JSON is YAML
        json.dump({"save_root": tmp, "data_backend": "folder", "dataset_root_list": [folder],
                   "batch_per_gpu": BATCH, "data_backend_impl": "grain",
                   "loss_cycle": 1, "test_cycle": NEVER, "ckpt_cycle": NEVER}, f)
    batches = []
    grain_next = GrainPipeline.__next__

    def recording_next(self):
        batch = grain_next(self)
        batches.append(batch)
        return batch
    with mock.patch.object(GrainPipeline, "__next__", recording_next):
        rc, host_batches, _, lines, launches, seconds = folder_run(train_mod, kernels, [
            "grain", "--config", config, "--ckpt_id", "smoke_init", "--max_step",
            str(start + GRAIN_STEPS), "--compute_dtype", "bfloat16", "--device", DEVICE])
    check(rc == 0 and not host_batches and len(batches) == GRAIN_STEPS,
          f"grain run: rc {rc}, {len(batches)} grain batches, {len(host_batches)} thread ones")
    for b in batches:
        check(b.dtype == torch.uint8 and tuple(b.shape) == (BATCH, RES, RES, 3)
              and b.device.type == torch.device(DEVICE).type, f"grain batch {b.dtype} {tuple(b.shape)}")
    want = {k: n * GRAIN_STEPS for k, n in STEP_LAUNCHES.items()}
    check(launches == want, f"grain run launches {launches}, expected {want}")
    dataset = ImageFolderDataset([folder], SCALE, cache_decoded=True)
    indices, _ = split_dataset(len(dataset))
    with GrainPipeline(dataset, BATCH, indices=indices, num_workers=8, device=DEVICE) as pipe:
        for _ in range(len(indices) // BATCH + 1):     # an epoch: the cache filled
            next(pipe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HIRES_RATE_BATCHES[256]):
            next(pipe)
        torch.cuda.synchronize()
        rate = HIRES_RATE_BATCHES[256] * BATCH / (time.perf_counter() - t0)
    print(f"[18 grain] data_backend_impl: grain, {GRAIN_STEPS} bf16 r1 steps at {RES}x{RES} "
          f"batch {BATCH} in {seconds:.2f} s: every batch uint8 on {batches[0].device}, "
          f"launches {launches}; GrainPipeline alone (8 threads, native loader) "
          f"{rate:.1f} img/s ({card})")


def run_hires_phase(train_mod, kernels, ckpt_lib, step_mod, cfg, depths, tmp, card, gen):
    """Phase 18: the native loader, grain, and config_1024.yaml at scales 7
    and 8. Returns the [18 kernels] times."""
    from pggan_tpu_torch.config import Config

    t_phase = time.perf_counter()
    grain_ok = loader_env()
    build_loader()
    folders = {256: os.path.join(tmp, "images_320"), 1024: os.path.join(tmp, "images_hires")}
    write_image_folder(folders[256])
    write_hires_folder(folders[1024])
    compare_loaders(folders, tmp)
    native8 = time_loader_pipelines(folders, tmp, card)
    time_loader_trainer(train_mod, kernels, ckpt_lib, cfg, depths, folders, tmp, card)
    cfg1024 = Config.from_yaml(os.path.join(REPO, CONFIG_1024))
    check([int(d) for d in cfg1024.depths] == [512, 512, 512, 512, 256, 128, 64, 32, 16]
          and {int(k): int(v) for k, v in cfg1024.batch_schedule.items()} == {7: 32, 8: 16},
          f"{CONFIG_1024}: depths {cfg1024.depths}, batch_schedule {cfg1024.batch_schedule}")
    arrays = run_hires_train(train_mod, kernels, ckpt_lib, cfg1024, folders[1024], tmp)
    state, images, run_cfg = time_hires_steps(step_mod, cfg1024, arrays, native8, gen, card)
    profile_hires_step(step_mod, run_cfg, state, images, card)
    del state, images
    torch.cuda.empty_cache()
    times = time_hires_kernels(kernels, gen, card)
    if grain_ok:
        run_grain_train(train_mod, kernels, ckpt_lib, cfg, depths, folders[256], tmp, card)
    else:
        print("[18 grain] grain is not installed on this machine: the grain phase did not run "
              "(not a failure caught)")
    print(f"[18 hires] phase 18 took {time.perf_counter() - t_phase:.2f} s")
    return times


# ---- phase 19: chunked dispatch ----------------------------------------------

class FixedBatches:
    """A stand-in for the trainer's data stream: the given batches in order."""

    def __init__(self, batches):
        self._batches = iter(batches)

    def __next__(self):
        return next(self._batches)

    def close(self):
        pass


def state_tensors(state):
    """{name: tensor} of what a step moves: the weights of G, D and G_ema,
    and Adam's moments and step counts."""
    out = {}
    for name, net in (("G", state.G), ("D", state.D), ("G_ema", state.G_ema)):
        if net is not None:
            out.update({f"{name}.{k}": t for k, t in net.state_dict().items()})
    for name, net, opt in (("opt_G", state.G, state.opt_G), ("opt_D", state.D, state.opt_D)):
        for pname, param in net.named_parameters():
            out.update({f"{name}.{pname}.{slot}": t
                        for slot, t in opt.state.get(param, {}).items()})
    return out


def snapshot(state):
    """(copies of `state_tensors`, the latent generator's state)."""
    return ({k: t.detach().clone() for k, t in state_tensors(state).items()},
            state.rng.get_state())


def restore(state, snap):
    """Write a snapshot back into the state's own tensors (the addresses the
    captured steps hold stay)."""
    tensors, rng = snap
    with torch.no_grad():
        for name, t in state_tensors(state).items():
            t.copy_(tensors[name])
    state.rng.set_state(rng)


def window_runs(trainer, run, batches):
    """`run()` (a window through the trainer) from the same state and batches
    twice: replaying the captured steps, then eager. The kinds of step it
    runs must be captured already. Returns {"graphs" | "eager": (snapshot
    after, the window's metrics)}."""
    start = snapshot(trainer.state)
    out = {}
    for label, use_graphs in (("graphs", True), ("eager", False)):
        restore(trainer.state, start)
        trainer.use_graphs = use_graphs
        trainer._pipeline = FixedBatches(batches)
        run()
        out[label] = (snapshot(trainer.state),
                      {k: v.clone() for k, v in trainer._last_metrics.items()})
    trainer.use_graphs = True
    return out


def window_difference(runs):
    """Graphs against eager: (tensors not equal bit for bit, the largest
    |diff| and where, generator states equal, metrics not equal bit for
    bit)."""
    (a, rng_a), m_a = runs["graphs"]
    (b, rng_b), m_b = runs["eager"]
    differs = [k for k in b if not torch.equal(a[k], b[k])]
    worst = max(((float((a[k].double() - b[k].double()).abs().max()), k) for k in differs),
                default=(0.0, None))
    metrics = [k for k in m_b if not torch.equal(m_a[k], m_b[k])]
    return differs, worst, torch.equal(rng_a, rng_b), metrics


def chunk_trainer(train_mod, tmp, ckpt_id, **keys):
    """A trainer resumed from `ckpt_id` in `tmp` on the card, `keys` set."""
    from pggan_tpu_torch.config import Config

    cfg = Config(dict({"save_root": tmp, "ckpt_id": ckpt_id, "use_mGPU": False,
                       "data_backend": "synthetic", "loss_cycle": NEVER,
                       "test_cycle": NEVER, "ckpt_cycle": NEVER}, **keys))
    with contextlib.redirect_stdout(io.StringIO()):
        return train_mod.create_model(cfg, device=DEVICE)


def run_chunk_parity(train_mod, kernels, ckpt_lib, cfg, depths, tmp):
    """[19 parity]: at full width, scale 6, batch 16, from phase 8's kind of
    checkpoint with the weight average on: a steps_per_dispatch window of
    CHUNK_K replays of the captured step, and a lazy window of CHUNK_K (the
    lead's graph and CHUNK_K − 1 replays of the tail's), each against the
    same window's eager steps from the same state and batches — f32, TF32
    off, cuDNN's deterministic algorithms: weights, G_ema, Adam's moments and
    counts, the generator's state and the metrics bit for bit; the lazy
    window again in bf16 (the largest difference printed). Returns the
    launches a replay of each kind."""
    _, _, _, start = train_checkpoint(ckpt_lib, cfg, depths, tmp)
    trainer = chunk_trainer(train_mod, tmp, "smoke_init", g_ema_decay=CHUNK_EMA,
                            steps_per_dispatch=CHUNK_K, compute_dtype="float32")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    launches = {}
    try:
        batches = [next(trainer._pipeline).clone() for _ in range(CHUNK_K)]
        trainer._pipeline.close()
        windows = (("steps_per_dispatch", lambda: trainer.train_chunk(CHUNK_K)),
                   ("lazy window", lambda: trainer.train_window(CHUNK_K)))
        for dtype in ("float32", "bfloat16"):
            if dtype == "bfloat16":
                trainer.cfg["compute_dtype"] = dtype
                trainer._build_step_fn()            # new steps: the graphs go
                windows = windows[1:]
            for label, run in windows:
                kernels.reset_launch_counts()
                trainer._pipeline = FixedBatches(batches)
                run()                               # its kinds' first runs capture them
                differs, worst, rng_equal, metrics = window_difference(
                    window_runs(trainer, run, batches))
                runner = trainer._graphs
                kinds = {kind: (c.launches, c.replays, round(c.seconds, 2))
                         for kind, c in runner.captured.items()}
                print(f"[19 parity] {label}, {dtype}, {CHUNK_K} steps at {RES}x{RES}, batch "
                      f"{BATCH}, g_ema_decay {CHUNK_EMA}: graph replays against eager "
                      f"steps: {len(differs)} of {len(state_tensors(trainer.state))} "
                      f"tensors differ (largest |diff| {worst[0]:.3g} at {worst[1]}), "
                      f"generator state {'equal' if rng_equal else 'DIFFERS'}, metrics "
                      f"differing {metrics}; captured (launches a replay, replays, "
                      f"capture s): {kinds}")
                if dtype == "float32":
                    check(not differs and rng_equal and not metrics,
                          f"{label}: the graph replays differ from the eager steps")
                    launches.update({kind: c.launches for kind, c in runner.captured.items()})
    finally:
        torch.backends.cudnn.deterministic = deterministic
        trainer.close()
    tail = dict(STEP_LAUNCHES, minibatch_stddev_stat=2)   # real and fake in one D forward
    check(launches == {"step": STEP_LAUNCHES, "lead": STEP_LAUNCHES, "tail": tail},
          f"launches a replay {launches}: expected step and lead {STEP_LAUNCHES}, tail {tail}")
    return launches


def expected_windows(start, end, k, cycle):
    """The steps where the trainer's steps_per_dispatch windows start over
    [start, end) with a loss line every `cycle` steps and no other host
    action (JAX's all-or-nothing rule)."""
    out, step = [], start
    while step < end:
        if step + k <= end and all(u % cycle for u in range(step, step + k)):
            out.append(step)
            step += k
        else:
            step += 1
    return out


def run_chunk_train(train_mod, kernels, ckpt_lib, cfg, tmp):
    """[19 train]: `pggan_tpu_torch.train.main --steps_per_dispatch auto` at
    scale CHUNK_SCALE, full width, batch 16, bf16, synthetic data, r1 every
    step, a loss line every CHUNK_LOSS_CYCLE steps: the windows (8 steps
    between the loss lines), the launches (wrapper calls at capture times
    replays), finite losses, the checkpoint; then the same run cut by a
    SIGTERM after CHUNK_CUT steps and resumed from its checkpoint, whose
    weights and Adam state at the end equal the uninterrupted run's bit for
    bit. Returns the launches the uninterrupted run's replays made."""
    from pggan_tpu_torch.train.trainer import ProgressiveGANTrainer

    arrays_g, arrays_d, start = hires_checkpoint(ckpt_lib, cfg, CHUNK_SCALE, tmp, "init_chunk")
    config = os.path.join(tmp, "chunk.yaml")
    with open(config, "w") as f:                    # JSON is YAML
        json.dump({"save_root": tmp, "loss_cycle": CHUNK_LOSS_CYCLE, "test_cycle": NEVER,
                   "ckpt_cycle": NEVER, "r1_interval": 1, "batch_per_gpu": BATCH}, f)
    end = start + CHUNK_RUN_STEPS
    trainers, windows = [], []
    chunk = ProgressiveGANTrainer.train_chunk

    def recording_chunk(self, k):
        windows.append((self.global_step, k))
        return chunk(self, k)

    def train(run, ckpt_id, hook=None):
        with recording_trainers(train_mod, trainers), \
                mock.patch.object(ProgressiveGANTrainer, "train_chunk", recording_chunk):
            return folder_run(train_mod, kernels, [
                run, "--config", config, "--ckpt_id", ckpt_id, "--max_step", str(end),
                "--compute_dtype", "bfloat16", "--data_backend", "synthetic",
                "--steps_per_dispatch", "auto", "--device", DEVICE, "--no_mGPU"], hook)

    rc, batches, run_cfg, lines, launches, seconds = train("chunk_a", "init_chunk")
    check(rc == 0, f"chunk_a returned {rc}")
    trainer = trainers[-1]
    want_windows = expected_windows(start, end, 8, CHUNK_LOSS_CYCLE)
    check(trainer._chunk_size == 8 and [s for s, _ in windows] == want_windows
          and all(k == 8 for _, k in windows),
          f"windows {windows}, expected 8 steps at {want_windows}")
    executed, text = executed_launches(launches, trainer)
    want = {k: n * CHUNK_RUN_STEPS for k, n in step_launches(CHUNK_SCALE).items()}
    check(executed == want, f"launches {executed}, expected {want}")
    check(len(batches) == CHUNK_RUN_STEPS, f"{len(batches)} batches for {CHUNK_RUN_STEPS} steps")
    losses = [line for line in lines if line.startswith("lossD:")]
    check(len(losses) == len(range(-(-start // CHUNK_LOSS_CYCLE) * CHUNK_LOSS_CYCLE, end,
                                   CHUNK_LOSS_CYCLE)), f"{len(losses)} loss lines")
    for line in losses:
        d, g = line.replace("lossD:", "").split("| lossG:")
        check(np.isfinite(float(d)) and np.isfinite(float(g)), f"loss line {line!r}")
    print(f"[19 train] pggan_tpu_torch.train.main --steps_per_dispatch auto at scale "
          f"{CHUNK_SCALE} ({4 * 2 ** CHUNK_SCALE}x{4 * 2 ** CHUNK_SCALE}), batch {BATCH}, bf16, "
          f"r1 every step, a loss line every {CHUNK_LOSS_CYCLE}: {CHUNK_RUN_STEPS} steps from "
          f"{start} in {seconds:.2f} s; windows of 8 at {want_windows}; losses finite; "
          f"launches: {text} = {CHUNK_RUN_STEPS} x {step_launches(CHUNK_SCALE)}")

    cut = []

    def sigterm_once(trainer):
        if trainer.global_step >= start + CHUNK_CUT and not cut:
            cut.append(trainer.global_step)
            os.kill(os.getpid(), signal.SIGTERM)
    rc, _, _, lines, _, _ = train("chunk_b", "init_chunk", sigterm_once)
    check(rc == 0 and len(cut) == 1, f"chunk_b returned {rc}, cut {cut}")
    stop = cut[0] + 1
    check(any(f"interrupted at step {stop}" in line for line in lines),
          f"chunk_b: no 'interrupted at step {stop}' line")
    rc, _, _, lines, _, _ = train("chunk_c", "chunk_b")
    check(rc == 0 and any(f"checkpoint chunk_b@{stop} restored" in line for line in lines),
          f"chunk_c returned {rc} or did not restore chunk_b@{stop}")
    differs = []
    for name in ("G", "D"):
        params_a, opt_a, _ = ckpt_lib.load_checkpoint(tmp, "chunk_a", name, end)
        params_c, opt_c, _ = ckpt_lib.load_checkpoint(tmp, "chunk_c", name, end)
        differs += [f"{name}:{k}" for arrays_a, arrays_c in ((params_a, params_c), (opt_a, opt_c))
                    for k in arrays_a if not np.array_equal(arrays_a[k], arrays_c[k])]
    check(not differs, f"the resumed run differs from the uninterrupted one at {differs[:5]}")
    print(f"[19 train] SIGTERM after step {cut[0]}: checkpoint at {stop}, resumed to {end}: "
          f"weights and Adam state equal the uninterrupted run's bit for bit")
    return trainer._graphs.launches_replayed()


def run_rates(card):
    """[19 rates]: tools/bench_e2e_torch.py in this process at RATE_SCALES,
    full width (configs.yaml), bf16, batch 16, synthetic data: every step
    with R1 one step a call against windows of RATE_WINDOW graph replays,
    and lazy R1/RATE_LAZY eager against graph replays; the trainer's img/s,
    the device time of each kind of step, the share of the trainer's time
    outside the steps, and the idle share. Returns the results."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bench_e2e_torch

    results = []
    for scale in RATE_SCALES:
        for label, extra in (("every step, 1 a call", ["--steps_per_dispatch", "1"]),
                             (f"every step, windows of {RATE_WINDOW} (graphs)",
                              ["--steps_per_dispatch", str(RATE_WINDOW)]),
                             (f"lazy R1/{RATE_LAZY}, eager", ["--r1_interval", str(RATE_LAZY),
                                                               "--eager"]),
                             (f"lazy R1/{RATE_LAZY}, graphs", ["--r1_interval", str(RATE_LAZY)])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = bench_e2e_torch.main([
                    "--scale", str(scale), "--batch", str(BATCH), "--steps",
                    str(RATE_STEPS[scale]), "--warmup", "2", "--profile", "--config",
                    os.path.join(REPO, "configs.yaml"), "--device", DEVICE, *extra])
            check(rc == 0, f"bench_e2e_torch at scale {scale}, {label} returned {rc}")
            result = json.loads(out.getvalue().splitlines()[-1])
            results.append(dict(result, label=label))
            res = 4 * 2 ** scale
            print(f"[19 rates] {res}x{res}, {label}: trainer {result['value']} img/s "
                  f"({result['step_ms']} ms a step over {result['steps']} steps); steps on "
                  f"the device {result['device_step_ms']} ms (graph replays) = "
                  f"{result['steps_ms']} ms a step; outside the steps "
                  f"{100 * result['outside_share']:.1f} %; device idle "
                  f"{100 * result['idle_share']:.1f} % ({card})")
    return results


def run_hires_chunk(train_mod, ckpt_lib, tmp, card):
    """[19 hires]: configs/config_1024.yaml at scale 8 (1024², batch 16),
    full width, bf16, r1 every step, steps_per_dispatch HIRES_CHUNK: the
    capture's seconds, two windows, and the peak memory."""
    from pggan_tpu_torch.config import Config

    hires = Config.from_yaml(os.path.join(REPO, CONFIG_1024))
    _, _, start = hires_checkpoint(ckpt_lib, hires, 8, tmp, "init_chunk8")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = chunk_trainer(train_mod, tmp, "init_chunk8", steps_per_dispatch=HIRES_CHUNK,
                            compute_dtype="bfloat16", r1_interval=1,
                            synthetic_dataset_size=64, num_data_workers=4)
    try:
        check(trainer.batch_size == 16 and trainer.schedule.scale_index == 8,
              f"batch {trainer.batch_size}, scale {trainer.schedule.scale_index}")
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.train_chunk(HIRES_CHUNK)
        losses = {k: float(v) for k, v in trainer._last_metrics.items()}
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        captured = trainer._graphs.captured["step"]
    finally:
        trainer.close()
    check(all(np.isfinite(v) for v in losses.values()), f"losses {losses}")
    print(f"[19 hires] config_1024.yaml at scale 8 (1024x1024), batch 16, bf16, r1 every step, "
          f"steps_per_dispatch {HIRES_CHUNK}: two windows in {seconds:.2f} s (the first step "
          f"eager, the capture {captured.seconds:.2f} s, then {captured.replays} replays); "
          f"losses finite; peak memory {peak:.0f} MiB (eager R1 step: 17456-17721 MiB, "
          f"phase 18) ({card})")


def run_chunk_data_parallel(train_mod, mesh, tmp):
    """[19 dp]: phase 17's group of one (NCCL) runs lazy windows of CHUNK_K,
    the step's all-reduce captured with it, and
    `check_replication_consistency` passes."""
    from pggan_tpu_torch.config import Config
    from pggan_tpu_torch.utils.debug import check_replication_consistency

    with torchrun_vars():
        mesh.init_distributed(Config({"use_mGPU": True}), DEVICE)
        try:
            trainer = chunk_trainer(train_mod, tmp, "smoke_init", compute_dtype="bfloat16",
                                    r1_interval=RATE_LAZY)
            try:
                check(trainer.distributed, "the trainer joined no process group")
                for _ in range(2):
                    trainer.train_window(CHUNK_K)
                losses = {k: float(v) for k, v in trainer._last_metrics.items()}
                check(trainer._replicas_checked, "the replicas were not checked")
                check_replication_consistency({"G": trainer.state.G, "D": trainer.state.D})
                replays = {k: c.replays for k, c in trainer._graphs.captured.items()}
            finally:
                trainer.close()
        finally:
            mesh.shutdown()
    check(all(np.isfinite(v) for v in losses.values()), f"losses {losses}")
    print(f"[19 dp] an NCCL group of world 1: two lazy windows of {CHUNK_K} with the "
          f"all-reduce captured in the lead's and the tail's graphs (replays {replays}); "
          f"losses finite; check_replication_consistency passed")


def run_chunk_phase(train_mod, kernels, ckpt_lib, mesh, cfg, depths, tmp, card):
    """Phase 19: chunked dispatch. Returns (the launches a replay of each
    kind, the launches the trainer run's replays made)."""
    t_phase = time.perf_counter()
    per_replay = run_chunk_parity(train_mod, kernels, ckpt_lib, cfg, depths, tmp)
    replayed = run_chunk_train(train_mod, kernels, ckpt_lib, cfg, tmp)
    run_rates(card)
    run_hires_chunk(train_mod, ckpt_lib, tmp, card)
    run_chunk_data_parallel(train_mod, mesh, tmp)
    print(f"[19 chunk] phase 19 took {time.perf_counter() - t_phase:.2f} s")
    return per_replay, replayed


def grid_faces(n_vertices, cols):
    """A stand-in for a mesh topology: vertex v at row v // cols,
    column v % cols, two triangles a grid cell whose corners all exist (the
    last row is partial), so vertices have 1-6 adjacent faces."""
    rows = -(-n_vertices // cols)
    idx = np.arange(rows * cols).reshape(rows, cols)
    a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    tris = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                           np.stack([b, d, c], -1).reshape(-1, 3)])
    return tris[(tris < n_vertices).all(axis=1)].astype(np.int32)


def zoo_state_dict(module, seed):
    """A numpy-seeded state_dict under `module`'s keys (the reference's, for
    the five reference networks): He-normal convs, N(0, 1/in) linears
    (EqualLinear N(0, 1)), biases and running means 0.1·N, running
    variances and BatchNorm scales U(0.5, 1.5), each residual branch's last
    BatchNorm (IR-SE `res_layer.4`, a basic block's `bn2`, a bottleneck's
    `bn3`) U(0.1, 0.3) as a trained network holds it, PReLU slopes U(0.1,
    0.4), LPIPS's 1×1 weights |N|/C, ReconNet's heads a tenth of He."""
    from pggan_tpu_torch.models import backbones, e4e

    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in module.state_dict().items():
        shape = tuple(value.shape)
        parent, _, leaf = key.rpartition(".")
        owner = module.get_submodule(parent)
        grand = module.get_submodule(parent.rpartition(".")[0])
        if leaf == "num_batches_tracked":
            sd[key] = np.asarray(0, np.int64)
            continue
        if leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("running_mean", "bias"):
            v = 0.1 * rng.standard_normal(shape)
        elif isinstance(owner, backbones.BatchNorm):
            residual = (key.endswith("res_layer.4.weight")
                        or (isinstance(grand, backbones.BasicBlock) and parent.endswith("bn2"))
                        or (isinstance(grand, backbones.Bottleneck) and parent.endswith("bn3")))
            v = rng.uniform(0.1, 0.3, shape) if residual else rng.uniform(0.5, 1.5, shape)
        elif isinstance(owner, torch.nn.PReLU):
            v = rng.uniform(0.1, 0.4, shape)
        elif isinstance(owner, e4e.EqualLinear):
            v = rng.standard_normal(shape, dtype=np.float32)
        elif "lpips_weights" in key:
            v = np.abs(rng.standard_normal(shape)) / shape[1]
        elif len(shape) == 4:
            v = rng.standard_normal(shape, dtype=np.float32) * math.sqrt(2.0 / np.prod(shape[1:]))
            if key.startswith("final_layers."):
                v = 0.1 * v
        else:
            v = rng.standard_normal(shape, dtype=np.float32) * math.sqrt(1.0 / shape[1])
        sd[key] = np.asarray(v, np.float32)
    return sd


def bfm_like_bases(seed):
    """The face model at the BFM 2009 front face's size (BFM_VERTICES
    vertices, BFM_LANDMARKS landmarks), numpy-seeded bases as the port's
    default draws them, and a grid triangulation."""
    v = BFM_VERTICES
    rs = np.random.RandomState(seed)
    return {"mean_shape": rs.randn(v * 3).astype(np.float32) * 0.1,
            "id_base": rs.randn(v * 3, 80).astype(np.float32) * 0.01,
            "exp_base": rs.randn(v * 3, 64).astype(np.float32) * 0.01,
            "mean_tex": rs.rand(v * 3).astype(np.float32),
            "tex_base": rs.randn(v * 3, 80).astype(np.float32) * 0.01,
            "landmark_index": rs.choice(v, BFM_LANDMARKS, replace=False).astype(np.int32),
            "face_buf": grid_faces(v, BFM_GRID_COLS)}


def zoo_networks():
    """(name, configuration, card module, CPU module, reference surface,
    input maker, forward) for each network of phase 20. Each card module
    takes its numpy-seeded state_dict with load_state_dict(strict=True) on
    the card; the CPU module is the same state_dict through the port's
    `convert_*_state_dict` where the reference has a key surface."""
    from pggan_tpu_torch.losses import perceptual
    from pggan_tpu_torch.models import backbones, e4e, face3d, faceparser, zoo

    def images(side):
        return lambda rng, n: (rng.uniform(-1, 1, (n, 3, side, side)).astype(np.float32),)

    def pairs(side):
        return lambda rng, n: images(side)(rng, n) + images(side)(rng, n)

    s = ZOO_SIDES
    return [
        ("arcface", f"IR-SE-50, {s['arcface']}², 512-d", lambda: backbones.IRSE(
            50, input_size=s["arcface"]), backbones.convert_arcface_state_dict, "ArcFace",
         images(s["arcface"])),
        ("bisenet", f"19 classes, ResNet-18 context path, {s['bisenet']}²",
         lambda: faceparser.BiSeNet(19), faceparser.convert_bisenet_state_dict,
         "BiSeNet (ResNet-18 keys under cp.resnet.)", images(s["bisenet"])),
        ("e4e", f"IR-SE-50, 18 styles of 512, {s['e4e']}²",
         lambda: e4e.Encoder4Editing(50, n_styles=18), e4e.convert_e4e_state_dict,
         "Encoder4Editing", images(s["e4e"])),
        ("reconnet", f"ResNet-50, 257 coefficients, {s['reconnet']}² → "
                     f"compute_for_render on {BFM_VERTICES} vertices",
         face3d.ReconNet, face3d.convert_reconnet_state_dict, "ReconNet",
         images(s["reconnet"])),
        ("lpips", f"AlexNet, pairs at {s['lpips']}²",
         lambda: perceptual.PerceptualDistance(device=DEVICE),
         functools.partial(perceptual.convert_lpips_state_dict, device="cpu"), "LPIPS",
         pairs(s["lpips"])),
        ("patchgan", f"n_layers 3, width 64, {s['patch']}²",
         lambda: zoo.PatchDiscriminator(3, 64, 3), None, None, images(s["patch"])),
        ("multiscale", f"3 scales x n_layers 6, width 64, {s['patch']}²",
         lambda: zoo.MultiscaleDiscriminator(3, 3, 64, 6), None, None, images(s["patch"])),
        ("stargan", f"img_size {s['patch']}, 1 domain",
         lambda: zoo.StarGANDiscriminator(s["patch"]), None, None, images(s["patch"])),
        ("latent", "code_dim 512, hidden 512 x 3",
         lambda: zoo.LatentDiscriminator(512), None, None,
         lambda rng, n: (rng.standard_normal((n, 512)).astype(np.float32),)),
    ]


def zoo_outputs(out):
    """A forward's outputs as a flat list of tensors."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, (list, tuple)) else [out]


def zoo_forward(net, xs, face=None):
    """A network's outputs as a flat list; with `face`, the coefficients
    and then `face.compute_for_render` of them."""
    out = net(*xs)
    if face is not None:
        return [out] + zoo_outputs(face.compute_for_render(out.float()))
    return zoo_outputs(out)


def zoo_windows_ms(fn):
    """ms a call of `fn`, one a window: 3 warm-up calls, then ZOO_WINDOWS
    windows of CUDA events, each of as many calls as fill ZOO_WINDOW_MS
    (from one timed call), sorted."""
    once = time_ms(fn, iters=1)
    iters = max(1, math.ceil(ZOO_WINDOW_MS / max(once, 1e-3)))
    return sorted(time_ms(fn, iters=iters, warmup=0) for _ in range(ZOO_WINDOWS))


def rel_err(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    check(got.shape == want.shape, f"shapes {tuple(got.shape)} and {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite values")
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@contextlib.contextmanager
def zoo_mode(mode):
    """f32 (TF32 off), tf32 (TF32 on for cuDNN and cuBLAS) or bf16
    (autocast); TF32 is off again afterwards, as chip_smoke runs."""
    tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.autocast("cuda", torch.bfloat16, enabled=mode == "bf16"):
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


def run_zoo_phase(kernels, card):
    """Phase 20: the submodel zoo at published sizes, batch ZOO_BATCH, on the
    card. Returns {"arcface" | "lpips": (card module, CPU module)} in f32
    for phase 21."""
    from torch.utils.flop_counter import FlopCounterMode

    from pggan_tpu_torch.losses import gan
    from pggan_tpu_torch.models import backbones, face3d

    t_phase = time.perf_counter()
    before = dict(kernels.launches)
    held = torch.cuda.memory_allocated()        # earlier phases' tensors
    kept = {}
    bases = bfm_like_bases(20)
    bases["point_buf"] = face3d.build_point_buf(bases["face_buf"], BFM_VERTICES)
    face_card = face3d.ParametricFaceModel(n_vertices=BFM_VERTICES, bases=bases, device=DEVICE)
    face_cpu = face3d.ParametricFaceModel(n_vertices=BFM_VERTICES, bases=bases, device="cpu")
    print(f"[20 zoo] face model: {BFM_VERTICES} vertices, {face_card.face_buf.shape[0]} "
          f"triangles (a grid), point_buf {tuple(face_card.point_buf.shape)}, "
          f"{BFM_LANDMARKS} landmarks")
    for index, (name, config, build, convert, surface, make_inputs) in enumerate(zoo_networks()):
        # 2. the state_dict (the reference's keys where it has them) loaded
        # strictly on the card, and through the converter on the CPU
        t0 = time.perf_counter()
        module = build()
        sd = zoo_state_dict(module, 2000 + index)
        module = module.to(DEVICE)
        module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        cpu = convert(sd) if convert else build()
        if not convert:
            cpu.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        module.to(memory_format=torch.channels_last)
        inputs = [torch.from_numpy(x) for x in make_inputs(np.random.default_rng(3000 + index),
                                                            ZOO_BATCH)]
        card_inputs = [x.to(DEVICE).contiguous(memory_format=torch.channels_last)
                       if x.ndim == 4 else x.to(DEVICE) for x in inputs]
        keys = f"{len(sd)} keys of the reference's {surface}" if surface else f"{len(sd)} keys"
        if name == "bisenet":
            resnet_sd = {k: v for k, v in sd.items() if k.startswith("cp.resnet.")}
            resnet_sd.update({"cp.resnet.fc.weight": np.zeros((1000, 512), np.float32),
                              "cp.resnet.fc.bias": np.zeros(1000, np.float32)})
            resnet = backbones.convert_resnet18_state_dict(resnet_sd, torch_prefix="cp.resnet.")
            keys += f"; its {len(resnet.state_dict())} ResNet-18 keys (+ fc, skipped) alone too"
        print(f"[20 zoo] {name} ({config}): {keys} loaded with strict=True on the card and "
              f"{'through the converter ' if convert else ''}on the CPU "
              f"({time.perf_counter() - t0:.2f} s)")

        face = face_card if name == "reconnet" else None
        # 1. the card's f32 forward (TF32 off) against the CPU's, the same
        # weights and inputs: the whole batch (ZOO_CPU_WHOLE; LPIPS's
        # output is the batch mean) or the samples ZOO_CPU_ROWS; the face
        # model's outputs against the CPU face model on the card's
        # coefficients
        rows = torch.arange(ZOO_BATCH) if name in ZOO_CPU_WHOLE else torch.tensor(ZOO_CPU_ROWS)
        with torch.no_grad(), zoo_mode("f32"):
            got = zoo_forward(module, card_inputs, face)
            torch.cuda.synchronize()
            want = zoo_forward(cpu, [x[rows] for x in inputs])
            if face is not None:
                want += zoo_outputs(face_cpu.compute_for_render(got[0].cpu()))
            if name == "lpips":                 # and the five taps of the first images
                got += module.features(card_inputs[0])
                want += cpu.features(inputs[0])
            errs = [rel_err(g if g.ndim == 0 or i > 0 and face is not None
                            else g[rows.to(g.device)], w)
                    for i, (g, w) in enumerate(zip(got, want))]
        check(len(got) == len(want), f"{name}: {len(got)} outputs on the card, {len(want)} on "
                                     f"the CPU")
        err = max(errs)
        check(err <= ZOO_CARD_RTOL, f"{name}: card against CPU {err:.3g} of the largest "
                                    f"value (tolerance {ZOO_CARD_RTOL})")
        shapes = ", ".join(str(list(g.shape)) for g in got)
        print(f"[20 zoo] {name} card f32 (TF32 off) against the CPU on {len(rows)} of "
              f"{ZOO_BATCH} samples: max |diff| {err:.3g} of the largest value (tolerance "
              f"{ZOO_CARD_RTOL}); outputs {shapes}")

        # 3. input gradients, as the reference's losses take them (each
        # loss, a batch mean, is scaled by the batch: each sample's gradient
        # is then its own whatever the batch), against the CPU's float64
        # gradient: the whole batch for LPIPS, the samples ZOO_CPU_ROWS for
        # ArcFace. The card's float64 gradient is held to ZOO_GRAD_RTOL of
        # the largest value (id_loss itself computes in f32, as the
        # reference's does); its f32 one (TF32 off) to ZOO_GRAD32_RTOL in
        # each sample's norm. In f32 a ReLU input or a max-pool window within
        # rounding of its kink or tie sends the gradient another way on one
        # side: on an H100 five of LPIPS's 16 samples read 2.4e-5 to 1.7e-3
        # of their norm while 0.65 % of the batch's values moved beyond 1e-4
        # of the largest (the other samples: ~1e-6).
        # A wrong gradient is wrong in norm. The samples beyond 1e-5 of
        # their norm are printed.
        if name in ("arcface", "lpips"):
            rows = torch.arange(ZOO_BATCH) if name == "lpips" else torch.tensor(ZOO_CPU_ROWS)
            other = torch.from_numpy(make_inputs(np.random.default_rng(4000 + index),
                                                 ZOO_BATCH)[-1])
            f64, f32 = torch.float64, torch.float32
            grads = {}
            with zoo_mode("f32"):
                for where, net, x, y, pick, dtypes in (
                        ("card", module, card_inputs[0], other.to(DEVICE), rows.to(DEVICE),
                         (f64, f32)),
                        ("cpu", cpu, inputs[0][rows], other[rows], slice(None), (f64,))):
                    for dtype in dtypes:
                        net.to(dtype)
                        xd = x.detach().to(dtype).requires_grad_(True)
                        yd = y.to(dtype)
                        if name == "arcface":
                            with torch.no_grad():
                                target = net(yd)
                            loss = gan.id_loss(net(xd), target)
                        else:
                            loss = net(xd, yd)
                        (loss * xd.shape[0]).backward()
                        grads[where, dtype] = xd.grad[pick].cpu().double()
                        net.float()
            truth = grads["cpu", f64]
            err64 = float((grads["card", f64] - truth).abs().max() / truth.abs().max())
            diff32 = grads["card", f32] - truth
            dims = tuple(range(1, truth.ndim))
            per_sample = (diff32.square().sum(dims) / truth.square().sum(dims)).sqrt().tolist()
            rel32 = max(per_sample)
            flips = ", ".join(f"{int(r)} ({e:.2g})" for r, e in zip(rows, per_sample) if e > 1e-5)
            share32 = float((diff32.abs() > 1e-4 * truth.abs().max()).double().mean())
            check(err64 <= ZOO_GRAD_RTOL, f"{name}: float64 input gradient, card against CPU "
                                          f"{err64:.3g} (tolerance {ZOO_GRAD_RTOL})")
            check(rel32 <= ZOO_GRAD32_RTOL, f"{name}: f32 input gradient, card against the "
                                            f"CPU's float64: {rel32:.3g} of a sample's norm "
                                            f"(tolerance {ZOO_GRAD32_RTOL})")
            what = "d id_loss(IRSE(x), IRSE(y))/dx" if name == "arcface" else "d LPIPS(x, y)/dx"
            print(f"[20 zoo] {name} input gradient {what} on {len(rows)} samples, card against "
                  f"the CPU's float64: float64 max |diff| {err64:.3g} of the largest "
                  f"(tolerance {ZOO_GRAD_RTOL}); f32 (TF32 off) {rel32:.3g} of a sample's norm "
                  f"at most (tolerance {ZOO_GRAD32_RTOL}), {100 * share32:.4f} % of the values "
                  f"beyond 1e-4 of the largest; samples beyond 1e-5 of their norm: "
                  f"{flips or 'none'}")

        # 4. times: items/s in each mode with TFLOP/s (FLOPs of a forward
        # counted by FlopCounterMode) and peak memory; the idle share of a
        # bf16 forward under torch.profiler
        def run():
            return zoo_forward(module, card_inputs, face)

        with torch.no_grad():
            with FlopCounterMode(display=False) as counter:
                run()
            flops = counter.get_total_flops() / ZOO_BATCH
            for mode, peak in (("f32", F32_FLOPS), ("tf32", TF32_FLOPS), ("bf16", BF16_FLOPS)):
                with zoo_mode(mode):
                    run()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    windows = zoo_windows_ms(run)
                    mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
                ms = windows[len(windows) // 2]
                tflops = flops * ZOO_BATCH / ms / 1e9
                print(f"[20 zoo] {name} {mode}: {ms:.3f} ms a batch of {ZOO_BATCH} = "
                      f"{ZOO_BATCH * 1e3 / ms:.1f} {'pairs' if name == 'lpips' else 'items'}/s "
                      f"(median of {len(windows)} windows of >= {ZOO_WINDOW_MS:g} ms; "
                      f"{ZOO_BATCH * 1e3 / windows[-1]:.1f}-{ZOO_BATCH * 1e3 / windows[0]:.1f}); "
                      f"{tflops:.2f} TFLOP/s = {100e12 * tflops / peak:.1f} % of the {mode} "
                      f"peak ({flops / 1e9:.3f} GFLOP an item); peak memory {mib:.0f} MiB "
                      f"above what earlier phases hold ({card})")
            with zoo_mode("bf16"):
                wall, busy, _, top = profile_rows(run)
            check(busy > 0 and top, f"{name}: the profile saw no device time")
            print(f"[20 zoo] {name} bf16 forward under torch.profiler: wall {wall:.3f} ms, "
                  f"device busy {busy:.3f} ms (idle {100 * max(0.0, 1 - busy / wall):.1f} %), "
                  f"{sum(n for _, n, _ in top)} kernels; top: "
                  + "; ".join(f"{k[:60]} {ms:.3f} ms" for ms, _, k in top[:3]))
        if name in ("arcface", "lpips"):
            kept[name] = (module, cpu)
        del module, cpu
        torch.cuda.empty_cache()
    check(dict(kernels.launches) == before, "a kernel of this repo launched in phase 20")
    print(f"[20 zoo] no kernel of this repo launched (the zoo runs on cuDNN/cuBLAS through "
          f"torch); phase 20 took {time.perf_counter() - t_phase:.2f} s")
    return kept


# ---- phase 21: face-swap pairs into the zoo ---------------------------------

def draw_pairs(dataset, count, threads):
    """`count` pairs, pair i from RandomState(PAIR_SEED + i), through a pool
    of `threads`. Returns (pairs in order, seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        return dataset.get(i, np.random.RandomState(PAIR_SEED + i))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        pairs = list(pool.map(one, range(count)))
    return pairs, time.perf_counter() - t0


def run_pairs_phase(kernels, card, zoo, tmp):
    """Phase 21: PairedFaceDataset's pairs from phase 12's folder into phase
    20's ArcFace and LPIPS on the card, against their CPU forwards."""
    from pggan_tpu_torch.data import PairedFaceDataset
    from pggan_tpu_torch.losses import gan
    from pggan_tpu_torch.models import zoo as zoo_mod
    from pggan_tpu_torch.train.step import normalize_images

    t_phase = time.perf_counter()
    before = dict(kernels.launches)
    images = os.path.join(tmp, "images")
    write_image_folder(images)              # phase 12's folder, the same seed
    roots = [os.path.join(images, f"part{r}") for r in (0, 1)]
    dataset = PairedFaceDataset(roots, same_prob=PAIR_SAME_PROB, resolution=PAIR_SIDE)
    check([len(ps) for ps in dataset.per_root] == [FOLDER_IMAGES // 2] * 2,
          f"roots of {[len(ps) for ps in dataset.per_root]} images")
    pairs, _ = draw_pairs(dataset, PAIRS, 1)
    rates = {}
    for threads in PAIR_THREADS:            # a second dataset, the same seeds
        again, seconds = draw_pairs(PairedFaceDataset(roots, same_prob=PAIR_SAME_PROB,
                                                      resolution=PAIR_SIDE),
                                    PAIR_RATE_PAIRS, threads)
        rates[threads] = PAIR_RATE_PAIRS / seconds
        for i, (a, b) in enumerate(zip(pairs, again)):
            check(a[2] == b[2] and np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]),
                  f"pair {i} differs on a second draw with the same seed ({threads} threads)")
    for xs, xt, same in pairs:
        check(xs.dtype == xt.dtype == np.uint8 and xs.shape == xt.shape
              == (PAIR_SIDE, PAIR_SIDE, 3) and same in (0, 1), "a pair's arrays or flag")
    same = [p[2] for p in pairs]
    xs_u8 = torch.from_numpy(np.stack([p[0] for p in pairs]))
    xt_u8 = torch.from_numpy(np.stack([p[1] for p in pairs]))

    def normalise(u8):                      # NHWC uint8 → NCHW (channels_last) [-1, 1]
        return normalize_images(u8).permute(0, 3, 1, 2)

    def identity(arc, xs, xt):
        ea = arc(zoo_mod.interpolate2d(xs, 112 / PAIR_SIDE))
        eb = arc(zoo_mod.interpolate2d(xt, 112 / PAIR_SIDE))
        return ea, eb, gan.id_loss(ea, eb)

    def lpips_each(net, xs, xt):
        return torch.stack([net(xs[i:i + 1], xt[i:i + 1]) for i in range(xs.shape[0])])

    (arc, arc_cpu), (lpips, lpips_cpu) = zoo["arcface"], zoo["lpips"]
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), zoo_mode("f32"):
        xs, xt = normalise(xs_u8.to(DEVICE)), normalise(xt_u8.to(DEVICE))
        check(xs.dtype == torch.float32 and -1 <= float(xs.min()) and float(xs.max()) <= 1,
              "the pairs normalised on the card")
        got = list(identity(arc, xs, xt)) + [lpips(xs, xt), lpips_each(lpips, xs, xt)]
        torch.cuda.synchronize()
        xs_cpu, xt_cpu = normalise(xs_u8), normalise(xt_u8)
        want = list(identity(arc_cpu, xs_cpu, xt_cpu)) + [
            lpips_cpu(xs_cpu, xt_cpu), lpips_each(lpips_cpu, xs_cpu, xt_cpu)]
        labels = ("IRSE(Xs)", "IRSE(Xt)", "id_loss", "LPIPS", "LPIPS a pair")
        errs = {k: rel_err(g, w) for k, g, w in zip(labels, got, want)}
        arc_ms = zoo_windows_ms(lambda: identity(arc, xs, xt))
        lpips_ms = zoo_windows_ms(lambda: lpips(xs, xt))
    mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    for k, err in errs.items():
        check(err <= ZOO_CARD_RTOL, f"phase 21 {k}: card against CPU {err:.3g} of the largest "
                                    f"value (tolerance {ZOO_CARD_RTOL})")
    per_pair = got[-1].cpu().tolist()
    check(all(math.isfinite(v) for v in per_pair), "non-finite LPIPS")
    check(dict(kernels.launches) == before, "a kernel of this repo launched in phase 21")
    arc_med, lp_med = arc_ms[len(arc_ms) // 2], lpips_ms[len(lpips_ms) // 2]
    print(f"[21 pairs] PairedFaceDataset({len(roots)} roots of {FOLDER_IMAGES // 2} JPEGs of "
          f"{FOLDER_SIDE}², same_prob {PAIR_SAME_PROB}, {PAIR_SIDE}²): {PAIRS} pairs, "
          f"same_person {sum(same)} of {PAIRS} ({''.join(map(str, same))}); equal to a second "
          f"draw with the same seeds through {' and '.join(map(str, PAIR_THREADS))} threads")
    print(f"[21 pairs] card f32 (TF32 off) against the CPU, max |diff| over the largest value "
          f"(tolerance {ZOO_CARD_RTOL}): " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
          + f"; id_loss {float(got[2]):.6f}, LPIPS {float(got[3]):.6f} (pairs "
          f"{min(per_pair):.4f}-{max(per_pair):.4f})")
    print(f"[21 pairs] host pairs/s: " + ", ".join(
        f"{rates[t]:.1f} with {t} thread{'s' if t > 1 else ''}" for t in PAIR_THREADS)
        + f" ({PAIR_RATE_PAIRS} pairs, PIL decode + resize + flip + jitter of two images a "
          f"pair); ArcFace {2 * PAIRS * 1e3 / arc_med:.1f} items/s (resize to 112² + IRSE-50 "
          f"on Xs and on Xt + id_loss, {arc_med:.3f} ms for {2 * PAIRS} images, windows "
          f"{arc_ms[0]:.3f}-{arc_ms[-1]:.3f} ms); LPIPS {PAIRS * 1e3 / lp_med:.1f} pairs/s "
          f"({lp_med:.3f} ms a batch of {PAIRS}, windows {lpips_ms[0]:.3f}-{lpips_ms[-1]:.3f} "
          f"ms); peak memory {mib:.0f} MiB above what earlier phases hold; {card}")
    print(f"[21 pairs] no kernel of this repo launched; phase 21 took "
          f"{time.perf_counter() - t_phase:.2f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pggan_tpu_torch import demo
    from pggan_tpu_torch.config import Config
    from pggan_tpu_torch.ops import _build, kernels

    # f32 means f32 here: cuDNN would otherwise run f32 convolutions in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 card] nvidia-smi: {card}")
    print(f"[1 card] torch: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}; "
          f"TF32 off for f32 convolutions and matmuls")

    t0 = time.perf_counter()
    _build.load_library()
    libs = [os.path.relpath(so, REPO) for so in _build.library_paths().values()]
    print(f"[2 build] {', '.join(libs)} ready in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc per source, started together)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[2 build]   {line.strip()}")

    cfg = Config.from_yaml(os.path.join(REPO, "configs.yaml"))
    depths = [int(d) for d in cfg.depths]
    check(int(cfg.latent_dim) == 512 and depths == [512, 512, 512, 512, 256, 128, 64],
          f"configs.yaml is not the full-width model: {cfg.latent_dim}, {depths}")
    path_shapes = epilogue_shapes(depths, SCALE, BATCH)
    shapes = [(BATCH, 512)] + sorted(set(path_shapes)) + BRANCH_SHAPES
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    max_err = check_kernels(kernels, shapes, gen)
    for name, errs in max_err.items():
        print(f"[3 kernels] {name}: {len(shapes) + len(MISALIGNED)} inputs match the plain "
              f"version; "
              f"max |diff| f32 {errs[torch.float32]:.3g} (rtol 1e-5, atol 1e-6), "
              f"bf16 {errs[torch.bfloat16]:.3g} (rtol 1.6e-2, atol 1e-2)")

    with tempfile.TemporaryDirectory(prefix="pggan_smoke_") as tmp:
        run_demo(demo, kernels, cfg, depths, tmp)
        generator, _, _, alpha = demo.load_generator(tmp, "smoke", device=DEVICE)
    z = torch.randn((BATCH, int(cfg.latent_dim)), generator=gen, device=DEVICE)
    check_forward(kernels, generator, z, alpha)

    print(f"[6 times] card: {card}; call time: CUDA events, mean over 20 eager calls "
          f"({SMALL_ITERS} for inputs of at most {SMALL_NUMEL} elements, 10 for a whole "
          f"forward) after 3 warm-up, in (plain, kernel, kernel, plain) turns; device "
          f"time: 20 calls captured in a CUDA graph, 5 replays")
    with torch.no_grad():
        time_sampling(kernels, generator, z, alpha, card)
        times, rms = time_kernels(kernels, path_shapes, gen, card)
        time_launch_path(kernels, gen, card)
        time_block_heads(generator, depths, gen, card)

    # ---- the training slice ----
    from pggan_tpu_torch import train as train_mod
    from pggan_tpu_torch.ops import equalized
    from pggan_tpu_torch.train import step as step_mod
    from pggan_tpu_torch.utils import checkpoint as ckpt_lib

    max_err.update(check_train_kernels(kernels, path_shapes, gen))
    with tempfile.TemporaryDirectory(prefix="pggan_smoke_train_") as tmp:
        train_launches, args, arrays_g, arrays_d = run_train(
            train_mod, kernels, ckpt_lib, cfg, depths, tmp)
    step_cfg = Config(args)
    step_cfg["compute_dtype"] = "float32"
    compare_step(step_mod, kernels, equalized, step_cfg, arrays_g, arrays_d)
    probe_step(step_mod, kernels, equalized, step_cfg, arrays_g, arrays_d)
    print(f"[10 times] card: {card}")
    bf16_step_ms = time_train(step_mod, kernels, step_cfg, arrays_g, arrays_d, gen, card)
    train_times, _ = time_train_kernels(kernels, gen, card)

    # ---- the StyleGAN2-ops path ----
    from pggan_tpu_torch import ops

    max_err["bias_lrelu_gain"] = check_bias_act_kernel(kernels, path_shapes, gen)
    check_bias_act_rule(kernels, gen)
    ops_launches = run_ops_path(kernels, ops, gen)
    check_ops_on_card(ops)
    print(f"[11 times] card: {card}")
    ops_times = time_ops(kernels, ops, gen, card)

    # ---- training from a folder of images ----
    with tempfile.TemporaryDirectory(prefix="pggan_smoke_folder_") as tmp:
        run_folder_train(train_mod, kernels, ckpt_lib, cfg, depths, tmp, card, bf16_step_ms)

    # ---- validation, FID and KID on the training path ----
    with tempfile.TemporaryDirectory(prefix="pggan_smoke_eval_") as tmp:
        run_eval_train(train_mod, kernels, ckpt_lib, cfg, depths, tmp, card)

    # ---- the device data cache on the training path ----
    with tempfile.TemporaryDirectory(prefix="pggan_smoke_cache_") as tmp:
        run_cache_train(train_mod, kernels, ckpt_lib, cfg, depths, tmp, card, bf16_step_ms)

    # ---- the serving artifact ----
    with tempfile.TemporaryDirectory(prefix="pggan_smoke_serve_") as tmp:
        run_serving(demo, kernels, cfg, depths, tmp, card)

    # ---- a reference checkpoint imported, trained data-parallel ----
    from pggan_tpu_torch.parallel import mesh

    with tempfile.TemporaryDirectory(prefix="pggan_smoke_import_") as tmp:
        start = run_reference_import(demo, kernels, cfg, depths, tmp)
        _, cards = run_data_parallel(train_mod, kernels, ckpt_lib, tmp, start)
    with torchrun_vars():
        mesh.init_distributed(Config({"use_mGPU": True}), DEVICE)
        try:
            compare_dp_step(step_mod, equalized, mesh, step_cfg, arrays_g, arrays_d, gen)
            time_data_parallel(step_mod, mesh, step_cfg, arrays_g, arrays_d, gen, card)
        finally:
            mesh.shutdown()

    # ---- the native loader, grain, and config_1024.yaml at 512² and 1024² ----
    with tempfile.TemporaryDirectory(prefix="pggan_smoke_hires_") as tmp:
        run_hires_phase(train_mod, kernels, ckpt_lib, step_mod, cfg, depths, tmp, card, gen)

    # ---- chunked dispatch: windows as CUDA-graph replays ----
    with tempfile.TemporaryDirectory(prefix="pggan_smoke_chunk_") as tmp:
        per_replay, chunk_launches = run_chunk_phase(train_mod, kernels, ckpt_lib, mesh, cfg,
                                                     depths, tmp, card)
    print("[19 kernels] " + json.dumps({"kernels": [
        {"name": name, "route": "cuda", "launches_a_replay": {
            kind: n[name] for kind, n in per_replay.items()},
         "launches": chunk_launches[name]} for name, n in STEP_LAUNCHES.items() if n]}))

    # ---- the submodel zoo at published sizes, and face-swap pairs into it ----
    zoo = run_zoo_phase(kernels, card)
    with tempfile.TemporaryDirectory(prefix="pggan_smoke_pairs_") as tmp:
        run_pairs_phase(kernels, card, zoo, tmp)
    del zoo

    # Every kernel of the three paths at its largest f32 shape on them;
    # `launches` is the training run's count (the demo's is checked in
    # phase 4), and bias_lrelu_gain's the ops path's (phase 11). `ms` is the
    # call time, `device_ms` the device time in a CUDA graph. Bounds: each
    # input read once and each output written once at 3.35 TB/s, against a
    # few f32 operations per element at 67 TFLOP/s.
    rows, big = (BATCH, 4, 4, 512), (BATCH, 256, 256, 64)
    n_rows, n_big = int(np.prod(rows)), int(np.prod(big))
    entries = [
        ("pixel_norm", "norm_kernels.cu", ":57", rows,
         times[("pixel_norm", rows, torch.float32)], 2 * n_rows * 4, 3 * n_rows,
         rms[(rows, torch.float32)][0]),
        ("lrelu_pixel_norm", "norm_kernels.cu", ":179", big,
         times[("lrelu_pixel_norm", big, torch.float32)], 2 * n_big * 4, 4 * n_big, None),
        ("lrelu_pixel_norm_bwd", "norm_kernels.cu", ":186", big,
         train_times[("lrelu_pixel_norm_bwd", big, torch.float32)], 3 * n_big * 4,
         12 * n_big, None),
        ("minibatch_stddev_stat", "mb_stddev.cu", ":252", rows,
         train_times[("minibatch_stddev_stat", rows, torch.float32)],
         n_rows * 4 + BATCH // 4 * 4, 6 * n_rows, None),
        ("bias_lrelu_gain", "bias_act.cu", ":97", big,
         ops_times[("bias_lrelu_gain", torch.float32)], 2 * n_big * 4 + big[-1] * 4,
         4 * n_big, None),
    ]
    path_launches = dict(train_launches, bias_lrelu_gain=ops_launches["bias_lrelu_gain"])
    report = []
    for (name, source, line, shape, (kernel_ms, kernel_dev, plain_ms), nbytes, flops,
         lib_ms) in entries:
        b_ms, b_by = bound_ms(nbytes, flops)
        report.append({"name": name, "route": "cuda",
                       "source": f"pggan_tpu_torch/csrc/{source}",
                       "replaces": f"pggan_tpu/ops/pallas_kernels.py{line}",
                       "launches": path_launches[name],
                       "max_abs_err": max_err[name][torch.float32],
                       "ms": kernel_ms, "device_ms": kernel_dev,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": lib_ms,
                       "chunked_launches": chunk_launches[name],
                       "shape": list(shape), "dtype": "float32"})
    print(json.dumps({"kernels": report}))
    print(card)
    # the cards the run used: one, and every visible card on the spawn route
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
