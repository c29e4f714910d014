"""Drives the PyTorch port on one CUDA card and checks it: BootsTAPIR,
online TAPIR, TAPNext, their training, TAP-Net and TRAJAN, RoboTAP,
flow-assisted tracking, the Kubric training reader and the multi-device
layer (two ranks sharing the card).

  python3 chip_smoke.py [--records PATH]

Phases (any failure raises and exits non-zero):
  1. Card and build: prints the card's name and power limit (nvidia-smi) and
     builds every kernel of tapnet_tpu_torch/csrc, one nvcc per source.
  2. Kernels: each CUDA kernel against its plain PyTorch version on the card,
     at the shapes the 480x480 main path gives it, in fp32 and bf16 model
     dtype, timed with CUDA events beside the plain version and a bound from
     bytes and operations: the full-precision corr-tents (K1) and mixer
     block (K3), the per-frame (K2) and per-position (K2b) int8 corr-tents,
     which quantize their queries inside the kernel, with the per-position
     grid quantizer (quantize_rows, bit-equal to its plain version at the
     three grids; K2b on the grid quantized once, as the model runs it, and
     bit-equal to the inline route), the
     w8a8 mixer block (K4), the per-frame int8 3x3 convolution of the
     ExtraConvs (X), the per-pixel ExtraConvs layer (K6) and the
     full-precision ExtraConvs layer (K6f, its fp32 products as
     error-compensated TF32, beside five faulty plain layers that its fp32
     check must refuse: three of fused_extra_convs.fp_output_controls, and
     fp32_controls' one TF32 product and split without A_small . B_big; in
     bf16 its padded t and hidden must have zero rings). The int8 kernels' own int8 tensors are held against
     the plain version's too, beside wrong quantizations as controls; X's
     padded int8 frames must have a zero ring. K3 in fp32 (its products as
     error-compensated TF32) beside two faulty fp32 blocks that its limit
     must refuse (fused_mixer_block.fp32_controls: one TF32 product; the
     split without A_small . B_big). The records of K3 (served shape), K4,
     X, K6 and K6f split one launch by kernel
     (torch.profiler): K3 into its temporal half and its two products, K4
     into its temporal half and its MLP, X into its quantization and its
     product, K6 into LayerNorm and patch scale, conv_up and conv_out, K6f
     into LayerNorm, conv_up and conv_out (fp32: and the weights' split), at
     each grid. K3's served rows
     also time cuBLAS's two bare products (fp32: TF32 off), K6f's the
     model's unfused layer. grad-kernels: the gradients through K1, K2,
     K2b, K3, K4, X, K6 and K6f (their autograd Functions, `ops._vjp`) at
     the shapes of a train-bootstapir-256 step, under one fixed cotangent,
     bit-equal to autograd through their plain versions (float32; K1 and
     K3 in bf16 too), beside two controls that must be refused: the bare
     kernel launch (no grad_fn) and a Function that drops the last input's
     gradient. K1 also at the streamed frames' shapes (one frame, the three
     grids of 256x256): 64 queries (online) and 1024 (robotap-dense-256,
     whose record goes into the K1 rows as `at_runs`).
  3. Main path: the committed trained BootsTAPIR through TapirPredictor.
     The golden clip in fp32 (TF32 off) and bf16 against the JAX golden
     outputs, and in the predictor's default float32 at PyTorch's TF32
     settings (cuDNN on, matmul off), printed against the fp32 and the bf16
     limits and held to the bf16 ones; in full precision and in the four
     int8 configurations
     (a: w8a8 mixer with per-frame int8 correlation; b: per-position int8
     correlation; c: the JAX package's headline, a with the per-frame int8
     ExtraConvs and 2 refinement steps; d: the per-pixel int8 ExtraConvs,
     on a 24-frame clip). Then track_many over 480x480 videos in bf16 (250
     frames, chunk 128: the shapes phase 2 checks): the full-precision
     configuration, the same in the predictor's default float32
     (serve-480-fp32, PyTorch's TF32 settings at their defaults; its
     profile must name the float32 tensor-core GEMMs), int8 configuration
     a with num_pips_iter=2, bf16 with
     num_pips_iter=2 beside it, configuration b (K2b), the headline
     configuration with 1024 queries, and a with the per-pixel int8
     ExtraConvs (K6). The kernels' launch counters are set to 0 before each
     run and read after: a run must launch its own kernels and no other.
     extra-convs-fp-480: the trained model's five ExtraConvs layers through
     K6f on the backbone activations of served 480x480 videos (10 launches
     per video), each layer held against the model's own unfused float
     layer.
  3a. eval-synth: the held-out synthetic sets a and b of
     tools/make_eval_draws.py, rebuilt on the CPU from the committed JAX
     draws (tests/data/synth_eval_draws.npz) through the port's renderer,
     scored with the trained BootsTAPIR (TapirPredictor(query_chunk_size=32),
     `tapvid.evaluate.evaluate_dataset`, strided queries) in fp32 with TF32
     off, fp32 at PyTorch's TF32 defaults, bf16 and int8 a-d, against JAX's
     metrics on the same videos and weights
     (tests/data/synth_eval_jax_metrics.json): fp32 every metric within
     EVAL_FP32_TOL, the others' AJ within the guards written at the head.
  3b. Online TAPIR: OnlineTapirPredictor with the trained weights on the
     golden clip (init, a step per frame, add_points at frame 4) against the
     JAX stream (tests/data/bootstapir_golden_online.npz) in fp32 and bf16,
     and the stream against the port's offline causal model (K3 with
     causal=True); the int8 streams a-d against JAX's on two witness clips
     (tests/data/bootstapir_golden_online_int8.npz and its _clip2 sibling,
     each with its own 16-ulp witness; a config-c step launches K2 and X,
     never K6); then online-tapir-256 (causal TAPIR, bf16, 64
     queries, the JAX package's bench.py workload), online-bootstapir-256
     (the live demo's causal BootsTAPIR) and online-bootstapir-256-int8 (its
     configuration c, with the streaming w8a8 MLP timed), 50 timed
     one-frame steps each: 12 K1 launches per step (6 K2 and 10 X in c).
  4. TAPNext (ViT-B, seed-made weights from tools/tapnext_weights.py): the
     linear scan (K5) against its plain version bit for bit at the served
     shape beside faulty plain versions that the check must refuse, the
     golden clip against the JAX golden outputs (fp32 with TF32 off, and
     bf16), the time-chunked predictor against one pass, serve-tapnext-256
     (TapnextPredictor, 250-frame 256x256 videos, 256 queries, chunks of 50:
     60 K5 launches per video) and online-tapnext-256 (64 queries, one
     frame per step: no K5 launch).
  6. Training: K5b (the scan's backward) against its plain backward bit for
     bit at the training shapes ([9216, 24, 768] fp32, [1088, 128, 768] with
     h0 and dh_last carried, fp32 and bf16, an odd shape) beside four faulty
     plain backwards that the check must refuse, and a finite-difference
     row through the autograd Function; train-golden (the port's Trainer on
     tools/make_tapnext_train_golden.py's small TAPNext, both losses, 3
     steps, against the JAX numbers of tests/data/tapnext_train_golden.npz
     within that tool's limits); train-tapnext-256 (tapnext_experiment():
     ViT-B fp32 with remat, batch 8 x 24 frames x 256x256, 128 queries, a
     warm-up and 2 timed steps: 24 K5 and 12 K5b launches a step, and a
     one-step profile by layer); train-tapnextpp (tapnextpp_experiment() cut
     from 1024 to 256 frames, two chunks of 128: a warm-up and 1 timed
     step, and the gradient through the state carried between chunks).
  7. TAPIR training: train-golden-tapir (the port's Trainer on
     tools/make_tapir_train_golden.py's small BootsTAPIR, fp32 with TF32
     off, identity and shared query orders, 3 steps each, against the JAX
     numbers of tests/data/tapir_train_golden.npz within that tool's card
     limits; every step launches K1 and K3) and bootstrap-golden (one
     BootsTAP step the same way); train-bootstapir-256
     (bootstapir_experiment() at its own data size, batch 8 x 24 frames x
     256x256, 256 queries in chunks of 32, fp32 at PyTorch's TF32
     defaults: a warm-up and 3 timed steps, 96 K1 and 384 K3 launches a
     step); train-bootstapir-synth (the JAX package's synthetic recipe,
     batch 4 x 16 frames, 128 queries, schedule horizon 6000, its first 150
     steps from fresh weights: the mean loss of the last 50 steps at most
     two thirds of the first 50's); train-bootstrap-256 (BootsTAP
     self-training on the trained checkpoint, 4 x 16 frames at 256x256
     unlabeled plus a labeled anchor: a warm-up and a timed step).
  8. TAP-Net and TRAJAN (no hand-written kernel: cuDNN convolutions and
     PyTorch's products, as the JAX package's XLA ones; run before phase 7):
     tapnet-golden (full-width TAP-Net, tools/tapnet_weights.py's seed-made
     weights and running statistics, the golden clip: eval and training
     forwards and one step of each loss against
     tests/data/tapnet_golden.npz within tools/make_tapnet_golden.py's card
     limits, fp32 with TF32 off); trajan-golden (TrackAutoEncoder() at its
     published widths, one clip of 64 support tracks, one never visible,
     boundary frame 120, 64 queries with some past frame 153, JAX's dither
     fed, chunked against one pass, against tests/data/trajan_golden.npz);
     train-tapnet-256 (tapnet_experiment() at its own data size: batch 8 x
     24 x 256x256, 256 queries in chunks of 32, TF32 defaults, a warm-up
     and 2 timed steps, the running statistics moved); serve-trajan-150 (4
     clips x 256 support tracks x 150 frames, the 32 x 32 grid's 1024
     queries in decoder chunks of 256, a warm-up and 3 timed passes).
  9. RoboTAP, flow-assisted tracking and the Kubric reader (no new kernel;
     after phase 7): dense-golden (robotap.dense_tracking.track_many_points
     with the trained causal BootsTAPIR on the golden clip, 64 points across
     all frames, against JAX's, tests/data/bootstapir_golden_dense.npz from
     tools/make_dense_golden.py: fp32 with TF32 off within online-golden's
     fp32 limits, the flags equal but where JAX's combined visibility logit
     lies within the logit limit of the threshold; bf16 within the bf16
     limits); robotap-dense-256 (the configuration RoboTAP runs: 256x256,
     causal_bootstapir_config(), 1024 points, 100 frames; a warm-up and 2
     timed videos: query-feature seconds, ms a streamed frame by the host
     clock, peak memory, 12 K1 launches a frame; profiles of a 10-frame call
     and of its query features: the stream's device ms a frame, busy share;
     K1 at 1024 queries is held against its plain version in phase 2);
     robotap-cluster (robotap.clustering.compute_clusters at
     its default widths on 1024 planted rigid tracks x 100 frames in four
     4-DoF groups, interleaved in one region at the first frame and leaving
     it in their own directions, iters_before_split cut to
     CLUSTER_ITERS_BEFORE_SPLIT: every cluster at least 90% one group's, no
     group absent, and a split by the first frame's position refused);
     flow-assist
     (utils.flow_track_assist.interpolate_track at 256^2 x 48 frames of a
     smooth made-up flow, radius 20 and 8, against the plain CPU run: the
     final cost map within 1e-5 relative, the card's argmins along its track
     equal to the CPU's but at the CPU's near ties, counted);
     train-kubric-256 (write_examples writes made-up 24-frame 288x320
     examples; the training CLI's --data_dir path, data.kubric's reader and
     prepare_batch, feeds bootstapir_experiment() at its own data size: a
     warm-up and 2 timed steps, the batch's wait, 96 K1 and 384 K3 launches a
     step, a finite loss).
  10. multi_rank (after the TAPNext phases; the constants' header, MR_*):
     two ranks spawned once by tapnet_tpu_torch.parallel.launch.run_ranks
     share the card over gloo (NCCL refuses two ranks on one card), so the
     times are not a multi-GPU speed. serve-480-2rank (TapirPredictor(mesh=
     ...), the trained BootsTAPIR, 48 frames, fp32 and bf16 against one
     rank; K1 and K3 on both ranks), serve-tapnext-sp-2rank (ViT-B time-split
     over the ranks against one rank; 2 K5 launches a layer a rank),
     sp-scan-grad (the sequence-parallel scan at [9216, 24, 768], values and
     K5b gradients) and train-bootstapir-dp-2rank (one step of a 4-clip
     global batch, clips and then queries split, against the one-rank
     Trainer). Each cell's largest error over its limit, per-rank launches,
     wall and peak memory.
  11. The last line: {"ok": true, "device": {...}}.

Every phase prints its record as one JSON line (with `--records PATH`, also
written to PATH). Exits non-zero, and prints
no result, without a CUDA card or without the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from tapnet_tpu_torch.checkpoints.tapir_checkpoint import load_tapir_checkpoint  # noqa: E402
from tapnet_tpu_torch.inference import (  # noqa: E402
    OnlineTapirPredictor, OnlineTapnextPredictor, TapirPredictor,
    TapnextPredictor,
)
from tapnet_tpu_torch.models import layers, tapnext_losses  # noqa: E402
from tapnet_tpu_torch.models.ssm_vit import SsmVitConfig  # noqa: E402
from tapnet_tpu_torch import configs as train_configs  # noqa: E402
from tapnet_tpu_torch.data import synthetic  # noqa: E402
from tapnet_tpu_torch.training import trainer as trainer_lib  # noqa: E402
from tapnet_tpu_torch.models.tapir import (  # noqa: E402
    bootstapir_config, causal_bootstapir_config, causal_tapir_config,
    resize_video,
)
from tapnet_tpu_torch.ops import (  # noqa: E402
    _build, _vjp, corr_tents, fused_extra_convs, fused_mixer_block, mixer_math,
    qconv, scan,
)
from tapnet_tpu_torch.models import tapir as tapir_lib  # noqa: E402
from tapnet_tpu_torch.training import bootstrap as bootstrap_lib  # noqa: E402
from tapnet_tpu_torch.training import optimizers as optimizers_lib  # noqa: E402
from tapnet_tpu_torch.utils.sampling import (  # noqa: E402
    postprocess_occlusions, preprocess_frames,
)
from tools.golden_clip import CLIP_FRAMES, INT8_CONFIGS, make_clip  # noqa: E402
from tools.make_online_golden import (  # noqa: E402
    ADD_IDX, CLIP2_SEED, OUT_INT8_CLIP2 as GOLDEN_ONLINE_INT8_CLIP2, run_stream)
from tapnet_tpu_torch.tapvid import datasets as tapvid_datasets  # noqa: E402
from tapnet_tpu_torch.tapvid import evaluate as tapvid_evaluate  # noqa: E402
from tools.make_tapnext_golden import (  # noqa: E402
    CHUNK as TAPNEXT_GOLDEN_CHUNK, WEIGHT_SEED as TAPNEXT_SEED, golden_clip,
)
from tools.tapnext_weights import seeded_tapnext_params  # noqa: E402
from tools import make_tapnext_train_golden as train_golden  # noqa: E402
from tools import make_tapir_train_golden as tapir_golden  # noqa: E402
from tools import make_tapnet_golden as tapnet_golden  # noqa: E402
from tools import make_trajan_golden as trajan_golden  # noqa: E402
from tapnet_tpu_torch.models import tapnet as tapnet_lib  # noqa: E402
from tapnet_tpu_torch.trajan import track_autoencoder  # noqa: E402
from tapnet_tpu_torch.examples.trajan_roundtrip import (  # noqa: E402
    synthetic_tracks)
from tapnet_tpu_torch.checkpoints import convert as convert_lib  # noqa: E402
from tools.trajan_weights import seeded_trajan_params  # noqa: E402
from tapnet_tpu_torch.robotap import clustering, dense_tracking  # noqa: E402
from tapnet_tpu_torch.utils import flow_track_assist  # noqa: E402
from tapnet_tpu_torch.data import kubric_convert  # noqa: E402
from tapnet_tpu_torch.training import run as run_lib  # noqa: E402
from tools import make_dense_golden  # noqa: E402
from tapnet_tpu_torch.parallel import launch as launch_lib  # noqa: E402
from tapnet_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from tapnet_tpu_torch.parallel import sequence as sequence_lib  # noqa: E402
from tools.time_int8_kernels import (  # noqa: E402
    K3_PHASES, K4_PHASES, K6_PHASES, K6F_PHASES, X_PHASES,
    split_ms as kernel_split,
)

CHECKPOINT = os.path.join(REPO, "runs/bootstapir_synth/trained_params_f16.npy")
GOLDEN = os.path.join(REPO, "tests/data/bootstapir_golden.npz")
GOLDEN_INT8 = os.path.join(REPO, "tests/data/bootstapir_golden_int8.npz")
TAPNEXT_GOLDEN = os.path.join(REPO, "tests/data/tapnext_golden.npz")
GOLDEN_ONLINE = os.path.join(REPO, "tests/data/bootstapir_golden_online.npz")
GOLDEN_ONLINE_INT8 = os.path.join(
    REPO, "tests/data/bootstapir_golden_online_int8.npz")
EVAL_DRAWS = os.path.join(REPO, "tests/data/synth_eval_draws.npz")
EVAL_JAX_METRICS = os.path.join(REPO, "tests/data/synth_eval_jax_metrics.json")
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and operations/s
# by operand type (bf16 and int8 on the tensor cores). A float32-accurate
# product on the tensor cores costs three TF32 products (error-compensated
# TF32, as K3's float32 form computes it), so float32 operations are bound
# at a third of the 495 TFLOP/s TF32 peak, above the 67 TFLOP/s of the
# float32 pipes outside them. The int8 kernels' bounds use the int8
# tensor-core peak whatever the model's dtype: their products are int8 in
# both.
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: PEAK_TF32_FLOPS / 3,
              torch.int8: 1979e12}

# Main-path shapes of the served videos at 480x480 (refinement at 480 only,
# chunk 128, 250 frames): corr-tents grids per pyramid level (H, W, C), with
# BT = 250 frames and N = 128 queries, and the mixer block's x [B*N, T, C].
FRAMES, QUERIES, CHUNK, RES = 250, 256, 128, 480
CORR_LEVELS = [(120, 120, 128), (60, 60, 256), (30, 30, 256)]
MIXER_SHAPE = (CHUNK, FRAMES, 512)
# The ExtraConvs' low-resolution grids [FRAMES, H, W, 256] at the backbone's
# two resolutions (480x480 and the initial 256x256); the hidden is 4x wider.
EXTRA_GRIDS = [(60, 60), (32, 32)]
EXTRA_C = 256
# The headline workload of the JAX package (bench.py): 1024 queries.
HEADLINE_QUERIES = 1024
# TAPIR training: train-bootstapir-256 at bootstapir_experiment()'s own data
# size (batch 8 x 24 frames x 256x256, 256 queries in chunks of 32), and the
# shapes its step gives the kernels, at which grad-kernels checks them: K1
# at the three pyramid grids of 192 frames with 32 queries, K3 on
# [8 * 32, 24, 512], the ExtraConvs' 32x32x256 grid of 192 frames.
TRAIN_TAPIR_BATCH, TRAIN_TAPIR_FRAMES, TRAIN_TAPIR_QUERIES = 8, 24, 256
TRAIN_TAPIR_CHUNK, TRAIN_TAPIR_STEPS = 32, 3
GRAD_BT = TRAIN_TAPIR_BATCH * TRAIN_TAPIR_FRAMES
GRAD_CORR_LEVELS = [(64, 64, 128), (32, 32, 256), (16, 16, 256)]
GRAD_MIXER_SHAPE = (TRAIN_TAPIR_BATCH * TRAIN_TAPIR_CHUNK, TRAIN_TAPIR_FRAMES,
                    512)
GRAD_EXTRA_GRID = (32, 32)
# train-bootstapir-synth: the JAX package's recipe (README.md, Training),
# batch 4 x 16 frames, 128 queries, schedule horizon 6000, its first
# SYNTH_STEPS steps; the gate on the mean loss of the last 50 against the
# first 50. Cut from 500 steps to 150 for the script's time (to 200 before
# the multi_rank phase came): the phase is host-bound and took 365-556 s at
# 500 on the same card.
SYNTH_BATCH, SYNTH_FRAMES, SYNTH_QUERIES, SYNTH_HORIZON = 4, 16, 128, 6000
SYNTH_STEPS, SYNTH_GATE = 150, 2.0 / 3.0
# train-bootstrap-256: timed BootsTAP steps after the warm-up.
BOOTSTRAP_STEPS = 1
# The online paths' shapes. Each online step (256x256, ONLINE_QUERIES = 64)
# calls K1 on one frame, BT = 1, at the three pyramid grids of a 256x256
# frame. online-golden's offline causal run (the golden clip: 32 queries, 8
# frames) calls K3 with causal=True on x [32, 8, 512].
ONLINE_CORR_LEVELS = [(64, 64, 128), (32, 32, 256), (16, 16, 256)]
OFFLINE_CAUSAL_MIXER_SHAPE = (32, 8, 512)

# Kernel vs plain on the card. fp32, as (rtol, atol): summation order only.
# bf16 corr-tents, atol in units of max|grid row| * max|query row|, which
# bounds |corr|: both sides round the same correlation to bf16 and may land
# one step (<= 2^-7 |corr|) apart; the plain version also rounds the y-tent
# stage and the x-tents to bf16 (<= 2^-8 |corr| each) where the kernel keeps
# them fp32. Sum: 2^-6. bf16 mixer: elementwise, two bf16 steps of each
# value the two sides round separately (fused_mixer_block.bf16_error_limit).
CORR_FP32_TOL = (0.0, 1e-4)
CORR_BF16_STEPS = 2.0**-6
MIXER_FP32_TOL = (1e-4, 1e-4)
# Port on the card vs the JAX golden outputs (CPU, fp32). fp32 with TF32
# off: summation order in cuDNN/cuBLAS and the kernels (0.00066 px on the
# CPU). bf16: a different dtype than the golden run; held on the median and
# 95th percentile of the track error and on the visibility flags.
GOLDEN_FP32_TOL = dict(tracks=0.05, logits=5e-3)
GOLDEN_BF16_TOL = dict(median_px=0.5, p95_px=2.0, visible_agree=0.95)

# int8 corr-tents (K2, K2b), kernel vs plain, as (rtol, atol in units of
# max|plain|): the two make the same roundings at the same points (an exact
# integer correlation, one rounding to bf16, bf16 tent weights, float32 sums
# of two exact products per stage, the y-stage rounded to bf16, one float32
# multiply by the scale) and quantize with the same PyTorch code. What is
# left is float32 rounding.
CORR_Q8_TOL = (1e-6, 1e-6)
# w8a8 mixer block (K4), kernel vs plain, per element:
# fused_mixer_block.q8_error_limit. It is the full-precision block's
# allowance (bf16: two bf16 steps of each value the two sides round apart;
# fp32: 1e-4 absolute and relative) plus four deviations of a quarter of a
# row's int8 hidden values one step apart, each step worth
# hs[row] * |w2q[k, col]| * s2[col] in the output (about 0.03 * 0.022 here).
# The int8 tensors themselves: at most these shares of the operand (xq) and
# of the hidden (hq) apart at all, and at most `far` of either more than one
# step apart. (In bf16 a row whose largest hidden value lands a bf16 step of
# x1 apart gets another scale, which moves its large values by a few steps;
# a CPU simulation of the kernel's roundings gave 2% and 6% apart, 1e-4 more
# than one step. In fp32 only float32 noise separates the two: 1e-5, 1e-4, 0.)
MIXER_Q8_FLIP_SHARE = {
    torch.bfloat16: dict(xq=dict(share=0.06, far=1e-3),
                         hq=dict(share=0.15, far=1e-3)),
    torch.float32: dict(xq=dict(share=1e-3, far=1e-5),
                        hq=dict(share=5e-3, far=1e-5)),
}
# Controls for these limits: the kernel's own float32 hidden quantized the
# wrong way, held against the plain version's int8 hidden like the kernel's.
# `from_bf16_hidden` rounds the hidden to bfloat16 first (the fault of a
# kernel that keeps its hidden in bfloat16); `truncated` rounds toward zero
# where the kernel rounds to nearest. The float32 check must refuse both;
# the record shows each control's shares beside the limit in either dtype.
MIXER_Q8_CONTROLS = {
    "from_bf16_hidden": lambda hidden: mixer_math.quantize_rows(
        hidden.bfloat16().float())[0],
    "truncated": lambda hidden: torch.trunc(
        hidden * (127.0 / hidden.abs().amax(-1, keepdim=True).clamp_min(1e-8))
    ).to(torch.int8),
}
# Per-frame int8 conv (X), kernel vs plain: both quantize the same floats
# with the same IEEE division and round the same exact integers through the
# same float32 products in the same order, so the outputs should be equal
# bit for bit. The limit is one rounding of the output: 1e-6 of |y| in fp32,
# a bf16 step (2^-7 of |y|) in bf16. Its int8 operand against the plain
# version's: at most 1e-5 of the values one step apart and none further
# (expected: none at all). Checked at conv_up and conv_out of both grids of
# EXTRA_GRIDS, as a served video runs it.
CONV_Q8_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}
CONV_Q8_FLIPS = dict(share=1e-5, far=0.0)
# K6, kernel vs plain, per element: fused_extra_convs.q8_error_limit, four
# deviations of a sixteenth of each pixel's int8 hidden values one step
# apart (a step of hidden value k at pixel q moves out[p, col] at the 9
# pixels p that read q by hs[q] * |woq[col, tap, k]| * so[col]), plus the
# output's rounding (fp32 1e-5 absolute and relative; bf16 two bf16 steps of
# |y|). Its int8 hidden against the plain version's, in either model dtype:
# at most 0.5% of all values one step apart, 0.01% more than one step, and
# Q8_PIXEL_FLIP_SHARE (1/16) of any one pixel's: the layer is float32 from
# the LayerNorm on, and only float32 noise (LN sums, rsqrt, tanh) moves a
# patch or hidden value across a rounding boundary. Such flips cluster (see
# Q8_PIXEL_FLIP_SHARE): about 2e-5 of all values, a few per cent of some
# pixels'. (On the CPU against the JAX reference and the Pallas kernel at
# small widths: no step apart at all, 1e-6 in the output.)
EXTRA_Q8_FLIPS = dict(share=5e-3, far=1e-4,
                      row=fused_extra_convs.Q8_PIXEL_FLIP_SHARE)
# Controls for the int8 limits of X and K6, each held against the plain
# version's int8 tensor like the kernel's own: `truncated` rounds toward zero
# where the kernel rounds to nearest; `from_bf16` quantizes the bf16 rounding
# of the float32 value (a kernel that reads its operand in bf16);
# `multiplying` is the mixer's quantizer, x * (127 / amax), where the
# ExtraConvs divide by amax / 127. The fp32 check must refuse `truncated` and `from_bf16`;
# `multiplying` differs only where the last bit of the quotient crosses a
# half step, and its shares are recorded, not judged.
def _truncated(v, scale):
  return torch.trunc(v / scale).to(torch.int8)


def _multiplying(v, amax):
  return torch.clamp(torch.round(v * (127.0 / amax.clamp_min(1e-8))),
                     -127, 127).to(torch.int8)


# Controls of K6's output limit: fused_extra_convs.q8_output_controls, the
# plain layer with a fault (t32 rounded to bf16 before the residual; conv_out
# taps dequantized with the output pixel's scale), on the first
# K6_CONTROL_FRAMES frames, held against the plain output like the kernel's.
# The fp32 check must refuse both.
K6_CONTROL_FRAMES = 16

# K6f, kernel vs plain, per element: fused_extra_convs.fp_error_limit. fp32:
# the port's 1e-4, absolute and relative, against the plain version's
# float32 convolutions with TF32 off (the kernel's products are three TF32
# products of the operands' big and small parts, summed a K step at a time
# in the tensor cores and across steps in IEEE float32; the CPU tests
# emulate that in float64 within the limit at the served widths). bf16:
# four deviations of a 64th of the hidden
# values a bf16 step apart, and of the hidden shifts that the t values lying
# within float32 noise of a bf16 rounding midpoint may cause, through
# conv_out, plus two bf16 steps of |y| (the two round the output
# separately); fp_limit_assumptions reads both premises off the kernel's own
# t32 and hidden. Its controls, on the first K6_CONTROL_FRAMES frames:
# fused_extra_convs.fp_output_controls (the pad ring's hidden unmasked, the
# residual on bf16 t, the hidden in the other dtype) and, in fp32,
# fp32_controls (the plain layer with TF32 matmuls on; the TF32 split
# without A_small . B_big); the fp32 check must refuse all five, and the
# bf16 ones are recorded. In extra-convs-fp-480
# each K6f layer is held against the model's unfused float layer on the same
# input, within fp_error_limit(unfused=True): every hidden value a step
# apart, plus the unfused layer's own roundings of t and of conv_out's
# output (half a step of each); that limit must refuse the unmasked pad.

# Port on the card vs the JAX int8 golden outputs (CPU, fp32 model dtype).
# fp32: the same integer products on bit-equal int8 values; float32 noise
# moves the rare activation across an int8 or bf16 rounding boundary, and
# that carries through 12 blocks and 4 refinement steps. Held on the points
# the golden run calls visible (the image pins them), on all points, on the
# median and on the logits. A flipped step sends the later roundings another
# way, so the deviation is a part of the quantization's own effect, not of
# float32 noise: configuration a moves the full-precision golden tracks by
# 0.089 px in the median and 2.7 px at most, b by 0.0089 and 3.1 px. The
# limits stay under that. The port on the CPU, whose float32 noise is
# another, is 0.17 / 1.5 / 0.011 px and 0.064 (a) and 0.0094 / 0.15 / 3e-5 px
# and 0.0078 (b) from the same golden outputs (tests/test_torch_golden.py).
# bf16: as the full-precision bf16 check.
# c and d add the int8 ExtraConvs, which requantize every layer's input: a
# flip in one layer moves the next layer's inputs at 9 pixels in every
# channel. The port on the CPU is 0.86 / 1.8 / 0.042 px and 0.11 (c) and
# 0.10 / 0.84 / 0.0017 px and 0.082 (d) from the golden outputs; c's own
# quantization moves the float golden tracks by 0.20 px in the median and
# 61 px at most (a near-tied stage-1 peak flips). The limits are about 3x
# the CPU's.
GOLDEN_INT8_FP32_TOL = {
    "a": dict(visible_px=1.5, any_px=4.0, median_px=0.05, logits=0.3),
    "b": dict(visible_px=0.15, any_px=1.0, median_px=5e-3, logits=0.05),
    "c": dict(visible_px=3.0, any_px=6.0, median_px=0.15, logits=0.4),
    "d": dict(visible_px=0.5, any_px=3.0, median_px=0.01, logits=0.3),
}
# Online TAPIR. online-golden: the trained causal BootsTAPIR on the golden
# clip against the JAX stream, under the BootsTAPIR golden limits
# (GOLDEN_FP32_TOL with TF32 off, GOLDEN_BF16_TOL); the stream against the
# port's offline causal model on the same clip (no add_points) under the same
# limits: the two compute the same function, the offline run through K3 with
# causal=True, the stream through the plain unfused blocks. online-tapir-256
# (bench.py:167, causal_tapir_config(compute_dtype="bfloat16")) and
# online-bootstapir-256 (the live demo's causal_bootstapir_config()): 64
# queries on frame 0 at 256x256, init, ONLINE_WARMUP steps, ONLINE_STEPS
# timed steps; K1 launches num_pips_iter x 3 pyramid grids = 12 per step.
ONLINE_QUERIES, ONLINE_WARMUP, ONLINE_STEPS = 64, 5, 50
ONLINE_K1_PER_STEP = 12
# The int8 streams (tests/data/bootstapir_golden_online_int8.npz, JAX's
# OnlineTapirPredictor with causal_bootstapir_config(**INT8_CONFIGS[name]),
# fp32): each step quantizes its own frame's grids, as JAX's stream does.
# A stream carries a step that float32 noise flipped across an int8
# rounding into every later step, so it may drift further from JAX's than
# the offline clip does. How far noise alone moves an int8 stream is read
# from JAX itself: the file also holds JAX's streams on the clip with every
# pixel nudged one float32 ulp (`<name>_nudged_<key>`). Limits, per
# configuration and measure: the offline ones (GOLDEN_INT8_FP32_TOL), or
# ONLINE_INT8_WITNESS x JAX's own distance from the nudged stream, whichever
# is larger (`online_int8_limits`). A stream also meets stage-1 near ties: a
# query whose cost volume has two peaks of nearly one height lands on either,
# as float32 noise moves an int8 rounding, and the causal state carries it
# there for the rest of the stream. A query that JAX's own nudged stream
# moves off the offline track limits is such a tie by JAX's own evidence
# (the witness's `flipped`: query 23 of c, queries 1 and 23 of d); it is
# held to no limit, and the witness's distances are taken on the other
# queries. Of the rest, at most ONLINE_INT8_FLIPPED may leave the track
# limits at some step; a query that add_points wrote (ADD_IDX) may be
# neither. The check records them all, and holds every other query to all
# the limits. Quantization
# itself moves JAX's streams from JAX's float stream by 8.5 (a), 1.2 (b), 78
# (c) and 74 px (d) at most and 0.13-7.2 in the logits; each configuration's
# limits must refuse the float stream, and the check holds that too.
ONLINE_INT8_WITNESS = 3.0
ONLINE_INT8_FLIPPED = 1
# The kernels each stream launches, and no other: the streaming mixer runs
# its w8a8 MLP as the plain `mixer_math.mlp_math_q8` (JAX's `mlp_block_q8`
# is XLA code, not a Pallas kernel), and the per-pixel ExtraConvs (K6)
# cannot fire on one frame (`wants_fused`), so d streams the per-frame int8
# convolution (X).
# K2 / K2b / K1 launch num_pips_iter x 3 pyramid grids a step.
ONLINE_INT8_LAUNCHES = {
    "a": {"corr_tents_q8_frame"},
    "b": {"corr_tents_q8_position", "corr_quantize"},
    "c": {"corr_tents_q8_frame", "extra_convs_q8_frame"},
    "d": {"corr_tents", "extra_convs_q8_frame"},
}
# online-bootstapir-256-int8: online-bootstapir-256 in configuration c (the
# JAX package's headline: w8a8 mixer, per-frame int8 correlation and
# ExtraConvs, 2 refinement steps): K2 at 2 x 3 grids and X at 5 layers x 2
# convolutions a step.
ONLINE_INT8_PER_STEP = {"corr_tents_q8_frame": 6, "extra_convs_q8_frame": 10}

# The kernels each int8 configuration must launch, and no other (the int8
# correlation quantizes its queries inside its kernel; b quantizes its grids
# per position with corr_quantize, once per video).
INT8_LAUNCHES = {
    "a": {"corr_tents_q8_frame", "mixer_block_q8"},
    "b": {"corr_tents_q8_position", "corr_quantize", "mixer_block"},
    "c": {"corr_tents_q8_frame", "mixer_block_q8", "extra_convs_q8_frame"},
    "d": {"corr_tents", "mixer_block", "extra_convs_q8_pixel"},
}

# eval-synth: the held-out sets of tools/make_eval_draws.py (a: the set of
# runs/bootstapir_synth/eval_trained.json; b: the out-of-domain set of
# runs/bootstap_demo), rebuilt on the CPU from the committed JAX draws through
# the port's `render_batch` (`synthetic.export_npz(draws=...)`) and read
# back with `create_kubric_dataset`, scored with the trained BootsTAPIR
# through TapirPredictor(query_chunk_size=32) and `evaluate_dataset`,
# strided queries, against JAX's metrics on JAX's own export of the same
# sets and weights (tests/data/synth_eval_jax_metrics.json, CPU).
# fp32 with TF32 off: each of the 13 mean metrics within EVAL_FP32_TOL of
# JAX's. The golden clip's tracks agree to 8.7e-4 px, so only point-frames
# within about 1e-3 px of a threshold can flip, and a video has about 7,700
# point-frames: a flip moves a video's metric by about 2e-4 and the mean of
# 16 by about 1e-5. Every other precision p: the AJ within
# max(EVAL_GUARD_FLOOR, 2 |AJ_JAX(p) - AJ_JAX(fp32)|) of JAX's AJ at p, on
# the same set. The predictor's default float32 at PyTorch's TF32 defaults
# (cuDNN on, matmul off), which JAX does not run, is held to JAX's fp32 AJ
# with bf16's spread. The guard catches a broken path; it is not a
# tolerance, and each measured gap is recorded. The int8 runs keep TF32 off,
# as the int8 golden checks do. EVAL_RUNS: (set, precision); "tf32" is the
# default float32.
EVAL_FP32_TOL = 1e-3
EVAL_GUARD_FLOOR = 0.005
EVAL_RUNS = (("a", "fp32"), ("a", "tf32"), ("a", "bf16"), ("a", "a"),
             ("a", "b"), ("a", "c"), ("a", "d"), ("b", "fp32"))
EVAL_LAUNCHES = dict(INT8_LAUNCHES, **{
    p: {"corr_tents", "mixer_block"} for p in ("fp32", "tf32", "bf16")})
# Where the rebuilt sets are written (listed in .gitignore), removed after
# the phase.
EVAL_DIR = os.path.join(REPO, "_eval_sets")

# TAPNext (ViT-B, SsmVitConfig()). serve-tapnext-256: 250-frame 256x256
# videos, 256 queries, chunks of 50 frames, bf16 compute dtype: the linear
# scan runs at [b * (1024 + queries), chunk, 768] float32 (the residual
# stream, and so the RG-LRU's input, stays float32 in bf16 mode).
# online-tapnext-256: the JAX package's bench.py workload
# (tapnext_online_ms_per_frame), 64 queries, one frame per step.
TN_RES, TN_FRAMES, TN_QUERIES, TN_CHUNK, TN_WIDTH = 256, 250, 256, 50, 768
TN_TOKENS = (TN_RES // 8) ** 2
SCAN_SHAPE = (TN_TOKENS + TN_QUERIES, TN_CHUNK, TN_WIDTH)
SCAN_ODD_SHAPE = (3, 12, 130)
TN_ONLINE_QUERIES, TN_ONLINE_STEPS = 64, 50
# K5 against its plain version: both make the same two roundings per step
# (multiply, then add, in float32) and the same cast of y, so they must be
# equal bit for bit (limit 0). The faulty plain versions (ops/scan.py
# scan_controls: an FMA-contracted step, a bfloat16 carry) must be refused.
# TAPNext on the card against the JAX golden outputs (CPU, seed-0 ViT-B
# weights, 4 frames, 16 queries). fp32 with TF32 off: float32 sums in other
# orders through 12 layers (the port on the CPU: 4e-6 on the logits, 3e-5
# px); logits within 2e-3, tracks within 0.05 px for >= 99% of point-frames
# (a near-tied coordinate bin of the random-weight head may flip: counted).
# bf16: as BootsTAPIR's bf16 golden check.
TN_GOLDEN_FP32_TOL = dict(logits=2e-3, track_px=0.05, share=0.99)
# The time-chunked predictor against one pass (both in the port, fp32): the
# recurrence is exact and attention per frame, so only the GEMMs' blocking
# differs: tracks within 0.01 px, occlusion logits within 1e-4 of their range.
TN_CHUNKED_TOL = dict(track_px=0.01, logit_of_range=1e-4)

# Training (phase 6). train-tapnext-256: tapnext_experiment() (ViT-B, fp32,
# 256x256) with remat, batch 8 x 24 frames, 128 queries: the scan runs at
# [8 * (1024 + 128), 24, 768]. train-tapnextpp: tapnextpp_experiment()
# (remat, batch 1, 64 queries, chunks of 128) cut from 1024 frames to 256,
# two chunks: [1024 + 64, 128, 768] per chunk. Timed steps after the
# warm-up: 2 and 1, to leave room for the TAPIR training phases within the
# script's time.
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_QUERIES, TRAIN_STEPS = 8, 24, 128, 2
TRAIN_SCAN_SHAPE = (TRAIN_BATCH * (TN_TOKENS + TRAIN_QUERIES), TRAIN_FRAMES,
                    TN_WIDTH)
TRAINPP_FRAMES, TRAINPP_QUERIES, TRAINPP_STEPS = 256, 64, 1
TRAINPP_SCAN_SHAPE = (TN_TOKENS + TRAINPP_QUERIES, 128, TN_WIDTH)
# K5b against its plain backward: the same two roundings per step, one for
# da's product and the same casts, so bit-equal (limit 0); the faulty plain
# backwards of ops/scan.py scan_backward_controls must be refused. A sanity
# row holds the backward to central finite differences of the forward (float32,
# step 1e-3 on a [2, 6, 8] scan): within 1e-2 of the largest gradient.
SCAN_FD_SHAPE, SCAN_FD_STEP, SCAN_FD_TOL = (2, 6, 8), 1e-3, 1e-2

# Phase 9: RoboTAP, flow-assisted tracking and the Kubric reader.
# dense-golden: track_many_points with the trained causal BootsTAPIR on the
# golden clip (tools/make_dense_golden.py: 8 frames, 64 points across all
# frames) against JAX's, fp32 with TF32 off under online-golden's fp32
# limits (GOLDEN_FP32_TOL), the flags equal except where JAX's combined
# visibility logit lies within the logit limit of the threshold; bf16 under
# GOLDEN_BF16_TOL. robotap-dense-256: the configuration RoboTAP runs
# (examples/robotap_clustering.py:62-68: 256x256, causal_bootstapir_config(),
# track_many_points' default 1024 points across all frames), a warm-up video
# and ROBOTAP_TIMED timed ones of ROBOTAP_FRAMES frames (the synthetic
# renderer's sprites, seeded): 12 K1 launches a streamed frame.
ROBOTAP_FRAMES, ROBOTAP_POINTS, ROBOTAP_TIMED = 100, 1024, 2
ROBOTAP_PROFILE_FRAMES = 10
# robotap-cluster: compute_clusters at its default widths (point_sample
# 2048, frame_sample 1024, 15 final and 25 most clusters, 4-DoF) on planted
# rigid tracks of the dense cell's size: CLUSTER_GROUPS groups, each a
# 4-DoF rigid motion (in-plane rotation, 2D translation, depth) of its own,
# all interleaved in one image region at the first frame and leaving it in
# their own directions, with CLUSTER_NOISE_PX of noise and CLUSTER_OCCLUDED
# of the point-frames occluded. iters_before_split is cut from 500 (17,000
# steps) to CLUSTER_ITERS_BEFORE_SPLIT (3,400 steps) for the script's time:
# tools/robotap_cluster_seeds.py reads this data pure at every seed tried
# at that cut (when cut, the optimization, JAX's too, depends on its draws;
# on groups that share a region throughout, its --layout carried, some
# seeds leave clusters mixed). Check: every recovered cluster takes at least CLUSTER_PURITY of
# its points from one planted group, and every group is the majority of
# some cluster; a control: a split by the first frame's position into
# quadrants must fail that check.
CLUSTER_TRACKS, CLUSTER_GROUPS = 1024, 4
CLUSTER_NOISE_PX, CLUSTER_OCCLUDED = 0.5, 0.1
CLUSTER_ITERS_BEFORE_SPLIT, CLUSTER_PURITY = 100, 0.9
# flow-assist: interpolate_track on a made-up smooth flow field (sums of
# sinusoids, a few px a frame) at FLOW_RES^2 x FLOW_FRAMES frames, at radius
# 20 (the function's default) and 8 (examples/flow_track_assist.py's),
# against the plain CPU run of the same steps on the same flow: the final
# cost map within FLOW_COST_RTOL relative, and at every step of the card's
# track the card's argmin equal to the CPU's, except where the CPU's best
# and second-best candidates at that pixel lie within FLOW_COST_RTOL of
# each other (a near tie, counted).
FLOW_RES, FLOW_FRAMES, FLOW_RADII, FLOW_COST_RTOL = 256, 48, (20, 8), 1e-5
# train-kubric-256: write_examples writes KUBRIC_EXAMPLES made-up examples
# (the synthetic renderer's, 24 frames of KUBRIC_HW, so prepare_batch
# resizes) under KUBRIC_DIR (listed in .gitignore, removed after); the
# training CLI's data path (run.make_data with --data_dir) feeds
# bootstapir_experiment() at its own data size (batch 8 x 24 x 256^2, 256
# queries, colour augmentation): a warm-up step and KUBRIC_STEPS timed ones.
KUBRIC_EXAMPLES, KUBRIC_HW, KUBRIC_STEPS = 16, (288, 320), 2
KUBRIC_DIR = os.path.join(REPO, "_kubric_examples")


def require(cond, msg):
  if not cond:
    raise RuntimeError(msg)


def card_line() -> str:
  res = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60,
  )
  return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps=10, warmup=2) -> float:
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ kernels


def corr_inputs(h, w, c, dtype, gen, bt=FRAMES, n=CHUNK):
  """Unit-norm, spatially smooth feature grids (neighbouring positions
  correlate, as the backbone's do), track centres spread over the frame and
  a few off its edges, and per query the feature of a grid position within
  1.5 cells of its centre plus noise: a correlation peak of about 0.95 in
  the window, as a tracked point gives. bt grids of n queries each."""
  dev = "cuda"
  grid = torch.randn(bt, c, h, w, device=dev, generator=gen)
  grid = F.avg_pool2d(grid, 3, stride=1, padding=1, count_include_pad=False)
  grid = F.normalize(grid, dim=1).permute(0, 2, 3, 1).contiguous()
  cy = torch.rand(bt, n, device=dev, generator=gen) * (h + 4) - 2.5
  cx = torch.rand(bt, n, device=dev, generator=gen) * (w + 4) - 2.5
  jitter = lambda: torch.rand(bt, n, device=dev, generator=gen) * 3 - 1.5
  sy = (cy + jitter()).round().clamp(0, h - 1).long()
  sx = (cx + jitter()).round().clamp(0, w - 1).long()
  query = grid[torch.arange(bt, device=dev)[:, None], sy, sx]
  noise = torch.randn(bt, n, c, device=dev, generator=gen) * (0.3 / c**0.5)
  query = F.normalize(query + noise, dim=-1)
  return grid.to(dtype), query.to(dtype), cy, cx


def corr_tol(grid, query):
  """(rtol, atol) of the corr-tents check for these inputs."""
  if grid.dtype == torch.float32:
    return CORR_FP32_TOL
  scale = float(grid.float().norm(dim=-1).max() * query.float().norm(dim=-1).max())
  return (0.0, CORR_BF16_STEPS * scale)


def corr_bound(grid, query, cy, cx, p=7):
  """Least bytes and operations of this run's corr-tents call: the grid
  positions the (p+1)^2 windows touch (each read once, at the size of the
  grid it is given: 1 byte for a pre-quantized grid), the queries, centres
  and outputs; 2*C operations per window position per query."""
  bt, h, w, c = grid.shape
  win = torch.arange(p + 1, device=cy.device)
  ys = torch.floor(cy).long()[..., None] - (p - 1) // 2 + win  # [BT, N, p+1]
  xs = torch.floor(cx).long()[..., None] - (p - 1) // 2 + win
  yy = ys[..., :, None].expand(-1, -1, -1, p + 1)
  xx = xs[..., None, :].expand(-1, -1, p + 1, -1)
  ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
  bb = torch.arange(bt, device=cy.device)[:, None, None, None].expand_as(yy)
  touched = torch.zeros(bt, h, w, dtype=torch.bool, device=cy.device)
  touched[bb[ok], yy[ok], xx[ok]] = True
  elt = grid.element_size()
  n = query.shape[1]
  nbytes = (int(touched.sum()) * c * elt
            + query.numel() * query.element_size()
            + (cy.numel() + cx.numel()) * 4 + bt * p * p * n * 4)
  flops = 2.0 * int(ok.sum()) * c
  return nbytes, flops


def mixer_inputs(dtype, gen, shape=MIXER_SHAPE):
  b, t, c = shape
  hid = 4 * c
  f = lambda *s: torch.randn(*s, device="cuda", generator=gen)
  args = [
      f(b, t, c), f(c) * 0.2 + 1, f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1,
      f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1, f(c) * 0.2 + 1,
      f(c, hid) / c**0.5, f(hid) * 0.1, f(hid, c) / hid**0.5, f(c) * 0.1,
  ]
  return [a.to(dtype) for a in args]


def mixer_bound(args):
  x, w1, w2 = args[0], args[7], args[9]
  rows = x.shape[0] * x.shape[1]
  c, hid = w1.shape
  elt = x.element_size()
  params = sum(a.numel() for a in args[1:])
  nbytes = 2 * x.numel() * elt + params * elt
  flops = 2.0 * rows * c * hid * 2
  return nbytes, flops


def bound_ms(nbytes, flops, dtype):
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[dtype] * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


COUNTERS = {
    "corr_tents": (corr_tents, "LAUNCHES"),
    "corr_tents_q8_frame": (corr_tents, "LAUNCHES_Q8_FRAME"),
    "corr_tents_q8_position": (corr_tents, "LAUNCHES_Q8_POSITION"),
    "corr_quantize": (corr_tents, "LAUNCHES_QUANTIZE"),
    "mixer_block": (fused_mixer_block, "LAUNCHES"),
    "mixer_block_q8": (fused_mixer_block, "LAUNCHES_Q8"),
    "extra_convs_q8_frame": (qconv, "LAUNCHES_Q8"),
    "extra_convs_q8_pixel": (fused_extra_convs, "LAUNCHES"),
    "extra_convs_fp": (fused_extra_convs, "LAUNCHES_FP"),
    "linear_scan": (scan, "LAUNCHES"),
    "linear_scan_backward": (scan, "BACKWARD_LAUNCHES"),
}


def reset_counts():
  for module, attr in COUNTERS.values():
    setattr(module, attr, 0)


def read_counts():
  return {name: getattr(m, attr) for name, (m, attr) in COUNTERS.items()}


def int_mm_ms(a, b):
  """Time of torch._int_mm(a [M, K], b [K, N]): a library's int8 product, a
  part of what the int8 kernels compute and used nowhere in the port. None
  if this PyTorch cannot run it."""
  try:
    torch._int_mm(a, b)  # pylint: disable=protected-access
    return time_ms(lambda: torch._int_mm(a, b))  # pylint: disable=protected-access
  except (RuntimeError, AttributeError) as err:
    print(f"torch._int_mm not timed: {err}", flush=True)
    return None


def corr_variants(dtype, gen):
  """Per corr-tents kernel: (name, per level a tuple of (shape, kernel call,
  plain call, tolerance, bound inputs, operand type of the bound, and a
  call that must give the kernel call's output bit for bit, or None))."""
  for name in ("corr_tents", "corr_tents_q8_frame", "corr_tents_q8_position"):
    levels = []
    for h, w, c in CORR_LEVELS:
      grid, query, cy, cx = corr_inputs(h, w, c, dtype, gen)
      if name == "corr_tents":
        run = lambda a=(grid, query, cy, cx): corr_tents.corr_tent_patches(*a, 7)
        plain = lambda a=(grid, query, cy, cx): (
            corr_tents.corr_tent_patches_reference(*a, 7))
        tol, bound_of, op_type = corr_tol(grid, query), grid, dtype
        same = None
      elif name == "corr_tents_q8_frame":
        # The grid is quantized once per video, outside the timed call.
        gq, gs = corr_tents.quantize_per_frame(grid)
        run = lambda a=(gq, gs, query, cy, cx): (
            corr_tents.corr_tent_patches_prequantized(*a, 7))
        plain = lambda a=(gq, gs, query, cy, cx): (
            corr_tents.corr_tent_patches_prequantized_reference(*a, 7))
        tol, bound_of, op_type, same = None, gq, torch.int8, None
      else:
        # Likewise the per-position grid (quantize_rows), as the model runs
        # it; the inline route, which quantizes the grid in the call, must
        # give the same bits.
        gq, gs = corr_tents.quantize_per_position(grid)
        run = lambda a=(gq, gs, query, cy, cx): (
            corr_tents.corr_tent_patches_prequantized_per_position(*a, 7))
        plain = lambda a=(gq, gs, query, cy, cx): (
            corr_tents.corr_tent_patches_prequantized_per_position_reference(
                *a, 7))
        same = lambda a=(grid, query, cy, cx): (
            corr_tents.corr_tent_patches(*a, 7, True))
        tol, bound_of, op_type = None, gq, torch.int8
      levels.append(((h, w, c), run, plain, tol,
                     (bound_of, query, cy, cx), op_type, same))
    yield name, levels


def path_record(records, shape, op_type, tol=None, mean_keys=()):
  """What one launch on the served path costs: the mean over `records`, one
  launch each at the shapes a served video gives the kernel in equal
  numbers, with the bound of their summed bytes and operations."""
  count = len(records)
  b_ms, b_by = bound_ms(sum(r["nbytes"] for r in records),
                        sum(r["flops"] for r in records), op_type)
  mean = lambda key: sum(r[key] for r in records) / count
  return dict(
      kernel=records[0]["kernel"], dtype=records[0]["dtype"], path=True,
      shape=shape, max_abs_err=max(r["max_abs_err"] for r in records),
      max_err_over_limit=max(r["max_err_over_limit"] for r in records),
      tol=records[0]["tol"] if tol is None else tol,
      ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=b_ms / count,
      bound_by=b_by, **{key: mean(key) for key in mean_keys})


def check_corr(dtype, gen, checks):
  name_dt = str(dtype).replace("torch.", "")
  for name, levels in corr_variants(dtype, gen):
    records = []
    for (h, w, c), run, plain, tol, bound_args, op_type, same in levels:
      out = run()
      torch.cuda.synchronize()
      ref = plain()
      torch.cuda.synchronize()
      extra = {}
      if same is not None:
        require(torch.equal(out, same()),
                f"{name} {name_dt} {h}x{w}x{c}: the pre-quantized route and "
                "the inline one differ")
        extra = dict(equals_inline_route=True, inline_route_ms=time_ms(same))
      if tol is None:
        tol = (CORR_Q8_TOL[0], CORR_Q8_TOL[1] * float(ref.abs().max()))
      diff = (out - ref).abs()
      err = float(diff.max())
      over = float((diff / (tol[1] + tol[0] * ref.abs())).max())
      require(bool(torch.isfinite(out).all()) and over <= 1.0,
              f"{name} {name_dt} {h}x{w}x{c}: max_abs_err {err}, tol {tol}, "
              f"{over} of the limit")
      nbytes, flops = corr_bound(*bound_args)
      b_ms, b_by = bound_ms(nbytes, flops, op_type)
      records.append(dict(
          kernel=name, dtype=name_dt, shape=[FRAMES, h, w, c, CHUNK],
          max_abs_err=err, max_err_over_limit=over,
          ref_max_abs=float(ref.abs().max()), tol=tol, ms=time_ms(run),
          plain_ms=time_ms(plain, reps=3), bound_ms=b_ms, bound_by=b_by,
          nbytes=nbytes, flops=flops, **extra))
      del out, ref, diff
    checks.extend(records)
    checks.append(path_record(
        records,
        f"mean of one launch at each of the {len(levels)} pyramid levels",
        levels[0][5], tol=max((r["tol"] for r in records), key=lambda t: t[1]),
        mean_keys=("inline_route_ms",) if "inline_route_ms" in records[0] else ()))
    del levels
    torch.cuda.empty_cache()
  check_quantize_rows(dtype, gen, checks)
  check_corr_online(dtype, gen, checks)
  check_corr_online(dtype, gen, checks, ROBOTAP_POINTS, "robotap_dense_256")


def check_quantize_rows(dtype, gen, checks):
  """The per-position grid quantizer (the kernel quantize_rows, via
  corr_tents.quantize_per_position) against its plain version
  _quantize_lastdim at the three served grids, which serve-480-int8-b
  quantizes once each per video (the int8 corr-tents quantizes its queries
  itself): bit-equal int8 values and scales. Bound: bytes, the values read
  once, the int8 values and the scales written once; a few float32
  operations a value."""
  name_dt = str(dtype).replace("torch.", "")
  records = []
  for h, w, c in CORR_LEVELS:
    v, _, _, _ = corr_inputs(h, w, c, dtype, gen)
    run = lambda v=v: corr_tents.quantize_per_position(v)
    plain = lambda v=v: corr_tents._quantize_lastdim(v)  # pylint: disable=protected-access
    (q, scale), (q_ref, scale_ref) = run(), plain()
    torch.cuda.synchronize()
    steps = int((q.int() - q_ref.int()).abs().max())
    scale_err = float((scale - scale_ref).abs().max())
    equal = torch.equal(q, q_ref) and torch.equal(scale, scale_ref)
    require(equal, f"quantize_rows {name_dt} grid {tuple(v.shape)}: "
            f"{steps} int8 steps, scales {scale_err} apart")
    nbytes = v.numel() * (v.element_size() + 1) + scale.numel() * 4
    flops = 3.0 * v.numel()  # |v| and its max, the division, the rounding
    b_ms, b_by = bound_ms(nbytes, flops, torch.float32)
    records.append(dict(
        kernel="corr_quantize", dtype=name_dt, operand="grid",
        shape=list(v.shape), max_abs_err=max(steps, scale_err),
        max_err_over_limit=0.0, tol="bit-equal (0)", ms=time_ms(run),
        plain_ms=time_ms(plain, reps=3), bound_ms=b_ms, bound_by=b_by,
        nbytes=nbytes, flops=flops))
    del v, q, scale, q_ref, scale_ref
    torch.cuda.empty_cache()
  checks.extend(records)
  checks.append(path_record(
      records, "mean of one serve-480-int8-b launch: each pyramid grid once",
      torch.float32))


def check_corr_online(dtype, gen, checks, n=ONLINE_QUERIES, run=None):
  """K1 at a streamed step's shapes (one frame, n queries, the three grids
  of a 256x256 frame) against its plain version, under the limits of the
  served shapes: the online step's ONLINE_QUERIES, and with `run` that
  run's n (robotap-dense-256: ROBOTAP_POINTS), whose levels' mean is also
  recorded as a path record of `run`."""
  name_dt = str(dtype).replace("torch.", "")
  records = []
  for h, w, c in ONLINE_CORR_LEVELS:
    grid, query, cy, cx = corr_inputs(h, w, c, dtype, gen, bt=1, n=n)
    run_k = lambda a=(grid, query, cy, cx): corr_tents.corr_tent_patches(*a, 7)
    plain = lambda a=(grid, query, cy, cx): (
        corr_tents.corr_tent_patches_reference(*a, 7))
    out = run_k()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    tol = corr_tol(grid, query)
    diff = (out - ref).abs()
    err = float(diff.max())
    over = float((diff / (tol[1] + tol[0] * ref.abs())).max())
    require(bool(torch.isfinite(out).all()) and over <= 1.0,
            f"corr_tents {name_dt} {run or 'online step'} {h}x{w}x{c} at {n} "
            f"queries: max_abs_err {err}, tol {tol}, {over} of the limit")
    nbytes, flops = corr_bound(grid, query, cy, cx)
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    records.append(dict(
        kernel="corr_tents", dtype=name_dt, path=False,
        run=run or "online step", shape=[1, h, w, c, n], max_abs_err=err,
        max_err_over_limit=over, tol=tol, ms=time_ms(run_k, reps=20),
        plain_ms=time_ms(plain, reps=5), bound_ms=b_ms, bound_by=b_by,
        nbytes=nbytes, flops=flops))
  checks.extend(records)
  if run is not None:
    checks.append(dict(
        path_record(records, "mean of one launch at each of the "
                    f"{len(records)} grids of a streamed frame, {n} queries",
                    dtype, tol=max((r["tol"] for r in records),
                                   key=lambda t: t[1])),
        path=False, path_of=run))


def int8_apart(q, ref_q):
  """How far an int8 tensor is from the plain version's: shares of values
  one step or more, and more than one step, apart, over all values and the
  largest over a row (the last axis)."""
  step = (q.to(torch.int16) - ref_q.to(torch.int16)).abs()
  total = step.numel()
  return dict(share=int(torch.count_nonzero(step)) / total,
              share_far=int(torch.count_nonzero(step > 1)) / total,
              max_steps=int(step.max()),
              max_row_share=int(torch.count_nonzero(step, dim=-1).max())
              / step.shape[-1])


def flips_within(record, allowed):
  """`allowed`: share (all values), far (more than one step) and, if given,
  row (the largest share of a row)."""
  return (record["share"] <= allowed["share"]
          and record["share_far"] <= allowed["far"]
          and record["max_row_share"] <= allowed.get("row", 1.0))


def judge_controls(name, dtype, controls, allowed):
  """Records whether the limits refuse each control; in fp32 they must
  refuse every control but `multiplying` (see the controls' comment)."""
  for key, record in controls.items():
    record["refused"] = not flips_within(record, allowed)
    require(record["refused"] or key == "multiplying" or dtype != torch.float32,
            f"{name}: the int8 limits {allowed} pass the control {key}: {record}")
  return controls


def check_mixer_q8(dtype, gen, checks):
  """K4 at MIXER_SHAPE against its plain version: the output within
  q8_error_limit, and the kernels' own int8 operand and hidden against the
  plain version's."""
  name = f"mixer_block_q8 {str(dtype).replace('torch.', '')}"
  args = mixer_inputs(dtype, gen)
  x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2 = args
  # As the model does: int8 weights made once, in Linear's storage layout.
  qweights = []
  for w in (w1, w2):
    q, scale = mixer_math.quantize_weight_cols(w)
    qweights += [q.t().contiguous().t(), scale]
  qweights = tuple(qweights)
  run = lambda: fused_mixer_block.mixer_block(
      *args, False, None, quantized=True, qweights=qweights)
  plain = lambda: fused_mixer_block.mixer_block_reference(
      *args, False, None, quantized=True, qweights=qweights)
  out = run()
  torch.cuda.synchronize()
  ref = plain()
  limit, xq_ref, hq_ref = fused_mixer_block.q8_error_limit(
      *args, False, None, qweights=qweights)
  torch.cuda.synchronize()
  diff = (out.float() - ref.float()).abs()
  err = float(diff.max())
  over = float((diff / limit.clamp_min(1e-30)).max())
  require(bool(torch.isfinite(out.float()).all()) and over <= 1.0,
          f"{name}: max_abs_err {err}, {over} of its limit")
  scratch = {}
  fused_mixer_block._launch_q8(  # pylint: disable=protected-access
      x, g1, wu, bu, wm, bm, g2, b1, b2, qweights, False, None, scratch)
  torch.cuda.synchronize()
  allowed = MIXER_Q8_FLIP_SHARE[dtype]
  flips = {}
  for key, ref_q in (("xq", xq_ref), ("hq", hq_ref)):
    flips[key] = int8_apart(scratch[key], ref_q)
    require(flips_within(flips[key], allowed[key]),
            f"{name}: int8 {key} {flips[key]} vs plain, allowed {allowed[key]}")
  controls = judge_controls(name, dtype, {
      key: int8_apart(fault(scratch["hidden"]), hq_ref)
      for key, fault in MIXER_Q8_CONTROLS.items()}, allowed["hq"])
  # The two bare int8 products through a library, as a yardstick of a part
  # of the function (no LayerNorm, temporal half, quantization or epilogue).
  w1q, _, w2q, _ = qweights
  up_ms = int_mm_ms(scratch["xq"], w1q)
  down_ms = int_mm_ms(scratch["hq"], w2q)
  del scratch, limit, xq_ref, hq_ref
  nbytes, flops = mixer_bound(args)
  b_ms, b_by = bound_ms(nbytes, flops, torch.int8)
  checks.append(dict(
      kernel="mixer_block_q8", dtype=str(dtype).replace("torch.", ""),
      path=True, shape=list(MIXER_SHAPE), max_abs_err=err,
      max_err_over_limit=over,
      tol="fused_mixer_block.q8_error_limit, per element",
      int8_flips_vs_plain=flips, int8_flip_limits=allowed,
      int8_flip_controls=controls,
      ms=time_ms(run), plain_ms=time_ms(plain, reps=3),
      bound_ms=b_ms, bound_by=b_by,
      bound_note="the function's own operations at the int8 peak; the kernel "
                 "computes the first product twice (1.5x the operations)",
      split_ms=kernel_split(run, K4_PHASES),
      int_mm_products_ms=(None if up_ms is None or down_ms is None
                          else up_ms + down_ms),
      int_mm_note="torch._int_mm on the two bare products only: a part of "
                  "the function, not a library call for the whole of it",
  ))
  del args, out, ref, diff
  torch.cuda.empty_cache()


def conv_q8_bound(x, cout):
  """Bytes and operations of one per-frame int8 conv: x read and y written
  once in the model dtype, the int8 weights and their scales; 2 * 9 * C_in
  operations per output value."""
  n, cin, h, w = x.shape
  elt = x.element_size()
  nbytes = x.numel() * elt + n * h * w * cout * elt + 9 * cin * cout + 8 * cout
  return nbytes, 2.0 * n * h * w * 9 * cin * cout


def check_conv_q8(dtype, gen, checks):
  """The per-frame int8 conv (X) at conv_up and conv_out of both grids of a
  served video, against its plain version: the output, and the kernel's int8
  operand against the plain version's, with controls."""
  name_dt = str(dtype).replace("torch.", "")
  records = []
  for (h, w), (cin, cout) in [(grid, io) for grid in EXTRA_GRIDS for io in (
      (EXTRA_C, 4 * EXTRA_C), (4 * EXTRA_C, EXTRA_C))]:
    name = f"extra_convs_q8_frame {name_dt} {h}x{w} {cin}->{cout}"
    x = torch.randn(FRAMES, h, w, cin, device="cuda", generator=gen)
    if cin > EXTRA_C:
      x = mixer_math.gelu(x)  # conv_out reads GELU outputs
    x = x.to(dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    k = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) / (3 * cin**0.5)
    b = torch.randn(cout, device="cuda", generator=gen) * 0.1
    qweights = qconv.quantize_conv_weight(k)
    run = lambda: qconv.conv2d_q8(x, None, b, qweights)
    plain = lambda: qconv.conv2d_q8_math(x, None, b, qweights)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    over = float((diff / (CONV_Q8_TOL[dtype] * ref.float().abs()).clamp_min(1e-30)).max())
    exact = bool(torch.equal(out, ref))
    require(bool(torch.isfinite(out.float()).all()) and over <= 1.0,
            f"{name}: max_abs_err {err}, {over} of its limit")
    del out, ref, diff
    scratch = {}
    qconv._launch_q8(x, qweights, b, scratch)  # pylint: disable=protected-access
    torch.cuda.synchronize()
    # The padded frames' ring, which the GEMM's shifted boxes read, is zero.
    ring = scratch["xq_padded"].clone()
    ring[:, 1:-1, 1:-1] = 0
    require(not bool(ring.any()), f"{name}: the padded operand's ring is not zero")
    del ring
    xf = x.permute(0, 2, 3, 1).float()
    xq_ref, xs_ref = qconv.quantize_per_frame(xf)
    flips = int8_apart(scratch["xq"], xq_ref)
    require(flips_within(flips, CONV_Q8_FLIPS),
            f"{name}: int8 operand {flips} vs plain, allowed {CONV_Q8_FLIPS}")
    scale = xs_ref[:, None, None, None]
    controls = judge_controls(name, dtype, {
        "truncated": int8_apart(_truncated(xf, scale), xq_ref),
        "from_bf16": int8_apart(qconv.quantize_per_frame(xf.bfloat16().float())[0],
                                xq_ref),
        "multiplying": int8_apart(_multiplying(xf, scale * 127.0), xq_ref),
    }, CONV_Q8_FLIPS)
    del scratch, xf, xq_ref, xs_ref, scale
    torch.cuda.empty_cache()
    nbytes, flops = conv_q8_bound(x, cout)
    b_ms, b_by = bound_ms(nbytes, flops, torch.int8)
    # For context, not a library call for this function: cuDNN's convolution
    # of the same shape in the model dtype (no quantization).
    k_dt, b_dt = k.to(dtype), b.to(dtype)
    cudnn_ms = time_ms(lambda: F.conv2d(x, k_dt, b_dt, padding=1))
    records.append(dict(
        kernel="extra_convs_q8_frame", dtype=name_dt,
        shape=[FRAMES, h, w, cin, cout], max_abs_err=err,
        max_err_over_limit=over, bit_equal=exact,
        tol=f"{CONV_Q8_TOL[dtype]} of |y|, per element",
        int8_flips_vs_plain=flips, int8_flip_limits=CONV_Q8_FLIPS,
        int8_flip_controls=controls, ms=time_ms(run),
        plain_ms=time_ms(plain, reps=2, warmup=1), bound_ms=b_ms,
        bound_by=b_by, nbytes=nbytes, flops=flops,
        cudnn_same_shape_ms=cudnn_ms, split_ms=kernel_split(run, X_PHASES)))
    del x, k, b, qweights, k_dt, b_dt
    torch.cuda.empty_cache()
  checks.extend(records)
  checks.append(path_record(
      records, "mean of one launch at conv_up and conv_out of the 60x60 and "
      "32x32 grids", torch.int8, mean_keys=("cudnn_same_shape_ms",)))


def extra_convs_inputs(h, w, dtype, gen):
  """One ExtraConvs layer at the served width: x [FRAMES, h, w, 256] and the
  layer's parameters, scaled so that conv_up's output and the residual are
  O(1), as the trained layers give."""
  c, m = EXTRA_C, 4 * EXTRA_C
  f = lambda *s: torch.randn(*s, device="cuda", generator=gen)
  return [f(FRAMES, h, w, c).to(dtype), f(c) * 0.2 + 1, f(c) * 0.1,
          f(3, 3, c, m) / (3 * c**0.5), f(m) * 0.1,
          f(3, 3, m, c) / (6 * m**0.5), f(c) * 0.1]


def check_extra_convs_q8(dtype, gen, checks):
  """K6 at the two grids of a served video, against its plain version: the
  output within fused_extra_convs.q8_error_limit, beside faulty plain layers
  as controls, and the kernel's int8 hidden against the plain version's,
  with controls."""
  name_dt = str(dtype).replace("torch.", "")
  records = []
  for h, w in EXTRA_GRIDS:
    name = f"extra_convs_q8_pixel {name_dt} {h}x{w}"
    x, g, bln, wu, bu, wo, bo = extra_convs_inputs(h, w, dtype, gen)
    qweights = fused_extra_convs.quantized_weights(wu, wo)
    run = lambda: fused_extra_convs.extra_convs_layer(
        x, g, bln, None, bu, None, bo, True, qweights=qweights)
    plain = lambda: fused_extra_convs.extra_convs_layer_reference(
        x, g, bln, None, bu, None, bo, True, qweights)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    limit, hq_ref = fused_extra_convs.q8_error_limit(x, g, bln, bu, bo, qweights)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    over = float((diff / limit.clamp_min(1e-30)).max())
    require(bool(torch.isfinite(out.float()).all()) and over <= 1.0,
            f"{name}: max_abs_err {err}, {over} of its limit")
    k = K6_CONTROL_FRAMES
    out_controls = {}
    for key, faulty in fused_extra_convs.q8_output_controls(
        x[:k], g, bln, bu, bo, qweights).items():
      apart = (faulty.float() - ref[:k].float()).abs()
      out_controls[key] = dict(
          max_abs_err=float(apart.max()),
          max_err_over_limit=float((apart / limit[:k].clamp_min(1e-30)).max()))
      out_controls[key]["refused"] = out_controls[key]["max_err_over_limit"] > 1.0
      require(out_controls[key]["refused"] or dtype != torch.float32,
              f"{name}: the output limit passes the control {key}: "
              f"{out_controls[key]}")
    del out, ref, diff, limit, apart, faulty
    scratch = {}
    fused_extra_convs._launch(x, g, bln, bu, bo, qweights, scratch)  # pylint: disable=protected-access
    torch.cuda.synchronize()
    flips = int8_apart(scratch["hq"], hq_ref)
    require(flips_within(flips, EXTRA_Q8_FLIPS),
            f"{name}: int8 hidden {flips} vs plain, allowed {EXTRA_Q8_FLIPS}")
    hidden, hs = scratch["hidden"], scratch["hs"][:, None]
    controls = judge_controls(name, dtype, {
        "truncated": int8_apart(_truncated(hidden, hs), hq_ref),
        "from_bf16": int8_apart(fused_extra_convs._q_rows(  # pylint: disable=protected-access
            hidden.bfloat16().float())[0], hq_ref),
        "multiplying": int8_apart(_multiplying(hidden, hs * 127.0), hq_ref),
    }, EXTRA_Q8_FLIPS)
    del scratch, hidden, hs, hq_ref
    torch.cuda.empty_cache()
    elt = x.element_size()
    m = 4 * EXTRA_C
    nbytes = 2 * x.numel() * elt + 2 * 9 * EXTRA_C * m + 4 * (3 * EXTRA_C + 2 * m)
    flops = 2 * 2.0 * FRAMES * h * w * 9 * EXTRA_C * m
    b_ms, b_by = bound_ms(nbytes, flops, torch.int8)
    records.append(dict(
        kernel="extra_convs_q8_pixel", dtype=name_dt,
        shape=[FRAMES, h, w, EXTRA_C], max_abs_err=err,
        max_err_over_limit=over,
        tol="fused_extra_convs.q8_error_limit, per element",
        output_controls=out_controls,
        int8_flips_vs_plain=flips, int8_flip_limits=EXTRA_Q8_FLIPS,
        int8_flip_controls=controls, ms=time_ms(run),
        plain_ms=time_ms(plain, reps=2, warmup=1), bound_ms=b_ms,
        bound_by=b_by, nbytes=nbytes, flops=flops,
        split_ms=kernel_split(run, K6_PHASES)))
    del x, g, bln, wu, bu, wo, bo, qweights
    torch.cuda.empty_cache()
  checks.extend(records)
  path = path_record(
      records, "mean of one launch at the 60x60 and 32x32 grids", torch.int8)
  path["ms_by_grid"] = {f"{r['shape'][1]}x{r['shape'][2]}": r["ms"] for r in records}
  path["split_ms_by_grid"] = {f"{r['shape'][1]}x{r['shape'][2]}": r["split_ms"]
                              for r in records}
  checks.append(path)


def extra_convs_fp_bound(x, m):
  """Bytes and operations of one K6f call: x read and y written once in the
  model dtype, the two weights in it, float32 LN parameters and biases; two
  3x3 products of 2 * 9 * C * M operations per pixel each."""
  n, h, w, c = x.shape
  elt = x.element_size()
  nbytes = 2 * x.numel() * elt + 2 * 9 * c * m * elt + 4 * (3 * c + m)
  return nbytes, 2 * 2.0 * n * h * w * 9 * c * m


def production_extra_convs(g, bln, wu, bu, wo, bo, dtype):
  """One layer of the model's own float ExtraConvs (`layers.ExtraConvs`,
  quantized=False: cuDNN convolutions and PyTorch elementwise passes) with
  these HWIO weights, in `dtype`; it takes NCHW."""
  c, m = wu.shape[2], wu.shape[3]
  module = layers.ExtraConvs(channels=c, num_layers=1, channel_multiplier=m // c)
  module.load_state_dict({
      "ln_0.scale": g, "ln_0.bias": bln,
      "conv_up_0.weight": wu.permute(3, 2, 0, 1), "conv_up_0.bias": bu,
      "conv_out_0.weight": wo.permute(3, 2, 0, 1), "conv_out_0.bias": bo})
  return module.to(device="cuda", dtype=dtype).eval()


def fp_limit_assumptions(x, params):
  """What fused_extra_convs.fp_error_limit assumes in bf16, read from the
  kernel's own t32 and hidden on x: its t32 within `ln_noise` of the plain
  version's, so that every t value which rounds to bf16 the other way is one
  the limit counts; and the share of hidden values a bf16 step apart from
  the plain hidden computed on the kernel's own t (the flips that the sums'
  order makes on its own) within FP_HIDDEN_FLIP_SHARE."""
  g, bln, wu, bu = params[:4]
  scratch = {}
  fused_extra_convs._launch_fp(x, *params, scratch=scratch)  # pylint: disable=protected-access
  torch.cuda.synchronize()
  t32, noise = fused_extra_convs.ln_noise(x, g, bln)
  t32_k = scratch["t32"]
  hidden = mixer_math.gelu(fused_extra_convs._conv_fp(  # pylint: disable=protected-access
      t32_k.to(x.dtype), wu, bu)).to(x.dtype)
  # The padded slabs of the bf16 kernel: zero rings (conv_up's epilogue
  # writes the hidden's), and t inside is t32 rounded.
  n, h, w, _ = x.shape
  ring = torch.ones(n, h + 2, w + 2, dtype=torch.bool, device=x.device)
  ring[:, 1:h + 1, 1:w + 1] = False
  rings_zero = all(float(scratch[k][ring].float().abs().max()) == 0.0
                   for k in ("t_padded", "hidden_padded"))
  t_is_rounded = torch.equal(scratch["t_padded"][:, 1:h + 1, 1:w + 1],
                             t32_k.to(x.dtype))
  found = dict(
      t32_apart_over_noise=float(((t32_k - t32).abs()
                                  / noise.clamp_min(1e-30)).max()),
      t_flip_share=float((t32_k.to(x.dtype) != t32.to(x.dtype)).float().mean()),
      near_midpoint_share=float(
          (fused_extra_convs._bf16_midpoint_distance(t32) <= noise)  # pylint: disable=protected-access
          .float().mean()),
      hidden_flip_share=float((scratch["hidden"] != hidden).float().mean()),
      hidden_flip_share_allowed=fused_extra_convs.FP_HIDDEN_FLIP_SHARE,
      padded_rings_zero=rings_zero, padded_t_is_t32_rounded=t_is_rounded)
  require(found["t32_apart_over_noise"] <= 1.0
          and found["hidden_flip_share"] <= found["hidden_flip_share_allowed"],
          f"K6f bf16: the limit's assumptions do not hold: {found}")
  require(rings_zero and t_is_rounded,
          f"K6f bf16: the padded slabs are wrong: {found}")
  return found


def check_extra_convs_fp(dtype, gen, checks):
  """K6f at the two grids of a served video against its plain version
  within fused_extra_convs.fp_error_limit, beside the faulty plain layers
  that the fp32 check must refuse (fp_output_controls, and in fp32
  fp32_controls); timed beside the plain version and the
  model's own unfused float layer (context: no single PyTorch call computes
  the layer)."""
  name_dt = str(dtype).replace("torch.", "")
  records = []
  torch.backends.cudnn.allow_tf32 = False
  for h, w in EXTRA_GRIDS:
    name = f"extra_convs_fp {name_dt} {h}x{w}"
    args = extra_convs_inputs(h, w, dtype, gen)
    x = args[0]
    run = lambda: fused_extra_convs.extra_convs_layer(*args, False)
    plain = lambda: fused_extra_convs.extra_convs_layer_reference(*args, False)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    limit = fused_extra_convs.fp_error_limit(*args)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    over = float((diff / limit.clamp_min(1e-30)).max())
    require(bool(torch.isfinite(out.float()).all()) and over <= 1.0,
            f"{name}: max_abs_err {err}, {over} of its limit")
    k = K6_CONTROL_FRAMES
    controls = {}
    faulty_layers = fused_extra_convs.fp_output_controls(x[:k], *args[1:])
    if dtype == torch.float32:
      faulty_layers.update(fused_extra_convs.fp32_controls(x[:k], *args[1:]))
    for key, faulty in faulty_layers.items():
      apart = (faulty.float() - ref[:k].float()).abs()
      ratio = float((apart / limit[:k].clamp_min(1e-30)).max())
      controls[key] = dict(max_abs_err=float(apart.max()),
                           max_err_over_limit=ratio, refused=ratio > 1.0)
      require(ratio > 1.0 or dtype != torch.float32,
              f"{name}: the limit passes the control {key}: {controls[key]}")
    require(len(controls) == (5 if dtype == torch.float32 else 3),
            f"{name}: controls {sorted(controls)}")
    del out, ref, diff, limit, apart, faulty, faulty_layers
    assumptions = (fp_limit_assumptions(x[:k], args[1:])
                   if dtype == torch.bfloat16 else None)
    torch.cuda.empty_cache()
    production = production_extra_convs(*args[1:], dtype)
    x_nchw = x.permute(0, 3, 1, 2)
    with torch.inference_mode():
      production_ms = time_ms(lambda: production(x_nchw), reps=5)
    nbytes, flops = extra_convs_fp_bound(x, args[3].shape[-1])
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    records.append(dict(
        kernel="extra_convs_fp", dtype=name_dt, shape=[FRAMES, h, w, EXTRA_C],
        max_abs_err=err, max_err_over_limit=over,
        tol=("fused_extra_convs.fp_error_limit, per element"
             + (" (1e-4 absolute and relative)" if dtype == torch.float32 else "")),
        output_controls=controls, limit_assumptions=assumptions,
        ms=time_ms(run, reps=5),
        plain_ms=time_ms(plain, reps=2, warmup=1), bound_ms=b_ms,
        bound_by=b_by, nbytes=nbytes, flops=flops,
        production_layer_ms=production_ms,
        split_ms=kernel_split(run, K6F_PHASES)))
    del args, x, production, x_nchw
    torch.cuda.empty_cache()
  torch.backends.cudnn.allow_tf32 = True
  checks.extend(records)
  path = path_record(
      records, "mean of one launch at the 60x60 and 32x32 grids", dtype,
      mean_keys=("production_layer_ms",))
  path["ms_by_grid"] = {f"{r['shape'][1]}x{r['shape'][2]}": r["ms"] for r in records}
  path["split_ms_by_grid"] = {f"{r['shape'][1]}x{r['shape'][2]}": r["split_ms"]
                              for r in records}
  checks.append(path)


def scan_inputs(shape, dtype, carried, gen, device="cuda"):
  """x, a [B, T, C] in `dtype` with a in (0.69, 0.99), as the RG-LRU's
  decays; h0 zero (a fresh sequence, the first chunk) or carried."""
  b, t, c = shape
  x = torch.randn(b, t, c, device=device, generator=gen).to(dtype)
  a = (torch.rand(b, t, c, device=device, generator=gen) * 0.3 + 0.69).to(dtype)
  h0 = (torch.randn(b, c, device=device, generator=gen) if carried
        else torch.zeros(b, c, device=device))
  return x, a, h0


def scan_bound(x):
  """Bytes and operations of one scan: x and a read, y written in their
  dtype, h0 read and h_last written in float32; a multiply and an add per
  element (float32)."""
  b, _, c = x.shape
  return 3 * x.numel() * x.element_size() + 2 * b * c * 4, 2.0 * x.numel()


def check_scan(gen, checks):
  """K5 against its plain version, bit for bit, at the served shape (fp32
  with h0 zero and carried, bf16 I/O) and an odd shape, beside the faulty
  plain versions that the check must refuse. The served path's row is fp32
  with a carried state (four of a video's five chunks)."""
  cases = [(SCAN_SHAPE, torch.float32, False), (SCAN_SHAPE, torch.float32, True),
           (SCAN_SHAPE, torch.bfloat16, True), (SCAN_ODD_SHAPE, torch.float32, True),
           (SCAN_ODD_SHAPE, torch.bfloat16, True),
           # The training shapes (phase 6).
           (TRAIN_SCAN_SHAPE, torch.float32, False),
           (TRAINPP_SCAN_SHAPE, torch.float32, True)]
  for shape, dtype, carried in cases:
    name_dt = str(dtype).replace("torch.", "")
    name = f"linear_scan {name_dt} {'x'.join(map(str, shape))} h0 {'carried' if carried else 'zero'}"
    x, a, h0 = scan_inputs(shape, dtype, carried, gen)
    run = lambda: scan.linear_scan(x, a, h0)
    plain = lambda: scan.linear_scan_reference(x, a, h0)
    y, h_last = run()
    torch.cuda.synchronize()
    ref_y, ref_h = plain()
    torch.cuda.synchronize()
    err = max(float((y.float() - ref_y.float()).abs().max()),
              float((h_last - ref_h).abs().max()))
    exact = bool(torch.equal(y, ref_y) and torch.equal(h_last, ref_h))
    require(exact, f"{name}: not bit-equal to its plain version, max_abs_err {err}")
    controls = {}
    for key, (fy, fh) in scan.scan_controls(x, a, h0).items():
      apart = max(float((fy.float() - ref_y.float()).abs().max()),
                  float((fh - ref_h).abs().max()))
      controls[key] = dict(max_abs_err=apart, refused=apart > 0.0)
      require(controls[key]["refused"],
              f"{name}: the bit-equality check passes the control {key}")
    del y, h_last, ref_y, ref_h
    nbytes, flops = scan_bound(x)
    b_ms, b_by = bound_ms(nbytes, flops, torch.float32)
    checks.append(dict(
        kernel="linear_scan", dtype=name_dt,
        path=shape == SCAN_SHAPE and dtype == torch.float32 and carried,
        shape=list(shape), h0="carried" if carried else "zero",
        max_abs_err=err, max_err_over_limit=0.0 if exact else float("inf"),
        tol="bit-equal (limit 0)", bit_equal=exact, controls=controls,
        ms=time_ms(run, reps=20), plain_ms=time_ms(plain, reps=3),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=flops))
    del x, a, h0
    torch.cuda.empty_cache()


def scan_backward_bound(y, dh_last):
  """Bytes and operations of one backward: dy, a and y read, dx and da
  written in their dtype; h0 (and dh_last) read and dh0 written in float32;
  per element a multiply and an add for g and a multiply for da (float32)."""
  b, _, c = y.shape
  states = 3 if dh_last is not None else 2
  return 5 * y.numel() * y.element_size() + states * b * c * 4, 3.0 * y.numel()


def check_scan_backward(gen, checks, device="cuda"):
  """K5b against its plain backward, bit for bit, at the training shapes
  (train-tapnext-256: fp32, h0 zero, no dh_last; train-tapnextpp's chunk:
  h0 carried and dh_last given), an odd shape and in bf16 I/O, beside the
  faulty plain backwards that the check must refuse; then a finite-
  difference sanity row through the autograd Function. The path row is the
  train-tapnext-256 shape."""
  cases = [(TRAIN_SCAN_SHAPE, torch.float32, False),
           (TRAINPP_SCAN_SHAPE, torch.float32, True),
           (TRAINPP_SCAN_SHAPE, torch.bfloat16, True),
           (SCAN_ODD_SHAPE, torch.float32, True),
           (SCAN_ODD_SHAPE, torch.bfloat16, True)]
  for shape, dtype, carried in cases:
    name_dt = str(dtype).replace("torch.", "")
    what = (f"linear_scan_backward {name_dt} {'x'.join(map(str, shape))} "
            f"{'h0 and dh_last carried' if carried else 'h0 zero'}")
    x, a, h0 = scan_inputs(shape, dtype, carried, gen, device)
    with torch.no_grad():
      y, _ = scan.linear_scan(x, a, h0)
    del x
    dy = torch.randn(shape, device=device, generator=gen).to(dtype)
    dh_last = (torch.randn(shape[0], shape[2], device=device, generator=gen)
               if carried else None)
    run = lambda: scan._launch_backward(dy, dh_last, a, h0, y)  # pylint: disable=protected-access
    plain = lambda: scan.linear_scan_backward_reference(dy, dh_last, a, h0, y)
    got = run()
    torch.cuda.synchronize()
    ref = plain()
    err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
    exact = all(torch.equal(g, r) for g, r in zip(got, ref))
    require(exact, f"{what}: not bit-equal to its plain backward, max_abs_err {err}")
    controls = {}
    zero = torch.zeros(shape[0], shape[2], device=device)
    for key, faulty in scan.scan_backward_controls(
        dy, zero if dh_last is None else dh_last, a, h0, y).items():
      if key == "drops_dh_last" and dh_last is None:
        continue
      if key == "h0_unrounded" and not carried:
        continue
      apart = max(float((f.float() - r.float()).abs().max())
                  for f, r in zip(faulty, ref))
      controls[key] = dict(max_abs_err=apart, refused=apart > 0.0)
      require(apart > 0.0, f"{what}: the bit-equality check passes the control {key}")
    del got, ref
    nbytes, flops = scan_backward_bound(y, dh_last)
    b_ms, b_by = bound_ms(nbytes, flops, torch.float32)
    checks.append(dict(
        kernel="linear_scan_backward", dtype=name_dt,
        path=shape == TRAIN_SCAN_SHAPE and dtype == torch.float32,
        shape=list(shape), h0="carried" if carried else "zero",
        dh_last=dh_last is not None, max_abs_err=err,
        max_err_over_limit=0.0 if exact else float("inf"),
        tol="bit-equal (limit 0)", bit_equal=exact, controls=controls,
        ms=time_ms(run, reps=20), plain_ms=time_ms(plain, reps=3),
        bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=flops))
    del a, h0, y, dy, dh_last
    torch.cuda.empty_cache()
  # Finite differences of L = sum(wy * y) + sum(wh * h_last) through the
  # autograd Function (K5 forward, K5b backward).
  x, a, h0 = scan_inputs(SCAN_FD_SHAPE, torch.float32, True, gen, device)
  wy = torch.randn(SCAN_FD_SHAPE, device=device, generator=gen)
  wh = torch.randn(SCAN_FD_SHAPE[0], SCAN_FD_SHAPE[2], device=device, generator=gen)
  loss = lambda x, a, h0: sum(
      (w * o).sum() for w, o in zip((wy, wh), scan.linear_scan(x, a, h0)))
  args = [t.clone().requires_grad_() for t in (x, a, h0)]
  before = scan.BACKWARD_LAUNCHES
  grads = torch.autograd.grad(loss(*args), args)
  require(scan.BACKWARD_LAUNCHES == before + 1, "the Function did not launch K5b")
  worst = 0.0
  with torch.no_grad():
    for i, (arg, grad) in enumerate(zip((x, a, h0), grads)):
      flat = arg.reshape(-1)
      for j in range(flat.numel()):
        plus, minus = [list((x, a, h0)) for _ in range(2)]
        for sign, inputs in ((1, plus), (-1, minus)):
          t = flat.clone()
          t[j] += sign * SCAN_FD_STEP
          inputs[i] = t.reshape(arg.shape)
        fd = (loss(*plus) - loss(*minus)) / (2 * SCAN_FD_STEP)
        worst = max(worst, abs(float(fd) - float(grad.reshape(-1)[j])))
  scale = max(float(g.abs().max()) for g in grads)
  require(worst <= SCAN_FD_TOL * scale,
          f"linear_scan gradients against finite differences: {worst} > "
          f"{SCAN_FD_TOL} * {scale}")
  checks.append(dict(kernel="linear_scan_backward", dtype="float32", path=False,
                     shape=list(SCAN_FD_SHAPE), check="finite differences",
                     max_abs_err=worst, max_err_over_limit=worst / (SCAN_FD_TOL * scale),
                     tol=f"{SCAN_FD_TOL} of max|grad|, central step {SCAN_FD_STEP}"))


def check_mixer(dtype, gen, checks, shape=MIXER_SHAPE, causal=False):
  """K3 at `shape` against its plain version: fp32 within MIXER_FP32_TOL,
  beside the faulty blocks of fused_mixer_block.fp32_controls that it must
  refuse; bf16 within fused_mixer_block.bf16_error_limit. The served path's
  row is MIXER_SHAPE with SAME padding."""
  name_dt = str(dtype).replace("torch.", "")
  name = f"mixer_block {name_dt} {'x'.join(map(str, shape))} causal={causal}"
  args = mixer_inputs(dtype, gen, shape)
  run = lambda: fused_mixer_block.mixer_block(*args, causal)
  plain = lambda: fused_mixer_block.mixer_block_reference(*args, causal)
  out = run()
  torch.cuda.synchronize()
  ref = plain()
  torch.cuda.synchronize()
  diff = (out.float() - ref.float()).abs()
  err = float(diff.max())
  require(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite")
  extra = {}
  if dtype == torch.float32:
    tol = MIXER_FP32_TOL
    over = float((diff / (tol[1] + tol[0] * ref.abs())).max())
    require(torch.allclose(out, ref, *tol),
            f"{name}: max_abs_err {err}, tol {tol}")
    controls = {}
    for key, faulty in fused_mixer_block.fp32_controls(*args, causal).items():
      ratio = float(((faulty - ref).abs() / (tol[1] + tol[0] * ref.abs())).max())
      controls[key] = dict(max_abs_err=float((faulty - ref).abs().max()),
                           max_err_over_limit=ratio, refused=ratio > 1.0)
      require(ratio > 1.0, f"{name}: the limit passes the control {key}: "
              f"{controls[key]}")
      del faulty
    extra["fp32_controls"] = controls
  else:
    tol = "2 bf16 steps of |h|, |x1|, |out| and rms(y), per element"
    limit = fused_mixer_block.bf16_error_limit(*args, causal)
    over = float((diff / limit.clamp_min(1e-30)).max())
    require(bool((diff <= limit).all()),
            f"{name}: max_abs_err {err}, {over} of its limit")
    del limit
  nbytes, flops = mixer_bound(args)
  b_ms, b_by = bound_ms(nbytes, flops, dtype)
  path = shape == MIXER_SHAPE and not causal
  if path:
    # For context, the two bare products through cuBLAS (no temporal half,
    # LayerNorm or epilogue; fp32 with TF32 off, as the port's fp32 runs),
    # which the port never calls.
    rows = args[0].reshape(-1, shape[-1])
    hidden = torch.empty(rows.shape[0], args[7].shape[1], dtype=dtype,
                         device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    extra.update(
        cublas_products_ms=time_ms(lambda: torch.matmul(rows, args[7]))
        + time_ms(lambda: torch.matmul(hidden, args[9])),
        cublas_note=f"torch.matmul of [32000, 512].[512, 2048] and "
                    f"[32000, 2048].[2048, 512] in {name_dt}"
                    + (" (TF32 off)" if dtype == torch.float32 else "")
                    + ": a part of the function, not a library call for the "
                    "whole of it",
        split_ms=kernel_split(run, K3_PHASES))
    del rows, hidden
  checks.append(dict(
      kernel="mixer_block", dtype=name_dt, path=path, causal=causal,
      shape=list(shape), max_abs_err=err, max_err_over_limit=over, tol=tol,
      ms=time_ms(run), plain_ms=time_ms(plain, reps=3),
      bound_ms=b_ms, bound_by=b_by, **extra,
  ))
  del args, out, ref, diff
  torch.cuda.empty_cache()


# ------------------------------------------------------- kernel gradients


class _DropsLastGradient(_vjp.PlainVjp):
  """A faulty Function, a control of grad-kernels: the plain VJP with the
  last input's gradient dropped."""

  @staticmethod
  def backward(ctx, grad):
    return _vjp.PlainVjp.backward(ctx, grad)[:-1] + (None,)


def _route_grads(out, inputs, cot):
  """The gradients of `out` under `cot` for `inputs` (None where one gets
  none), or None if `out` carries no gradient at all."""
  if out.grad_fn is None:
    return None
  return torch.autograd.grad(out, inputs, cot, allow_unused=True)


def _bit_equal(got, want):
  return got is not None and all(
      g is not None and torch.equal(g, w) for g, w in zip(got, want))


def grad_case(name, dtype, inputs, entry, forward, plain, counter, gen):
  """One kernel entry's gradients (grad-kernels): through the entry (the
  kernel's forward, the plain math's VJP) against autograd through the
  plain math, on the same inputs and one fixed cotangent, bit for bit; the
  entry must launch its kernel once; two controls must be refused: the
  kernel's bare launch (no grad_fn, what every entry but K5's returned
  before its VJP) and a Function that drops the last input's gradient."""
  leaves = [x.detach().requires_grad_() for x in inputs]
  reset_counts()
  out = entry(*leaves)
  torch.cuda.synchronize()
  launches = read_counts()[counter]
  cot = torch.randn(out.shape, device="cuda", generator=gen).to(out.dtype)
  got = _route_grads(out, leaves, cot)
  want = _route_grads(plain(*leaves), leaves, cot)
  ok = _bit_equal(got, want)
  controls = {}
  def bare_launch():
    with torch.no_grad():
      return forward(*leaves)

  for key, route in (
      ("bare_launch", bare_launch),
      ("drops_last_gradient",
       lambda: _DropsLastGradient.apply(forward, plain, *leaves))):
    faulty = _route_grads(route(), leaves, cot)
    controls[key] = dict(refused=not _bit_equal(faulty, want),
                         grad_fn=faulty is not None)
  apart = (None if got is None else max(
      float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)))
  record = dict(
      kernel=name, check="gradient", dtype=str(dtype).replace("torch.", ""),
      shapes=[list(x.shape) for x in inputs], launches=launches,
      bit_equal=ok, max_abs_diff=apart,
      grad_abs_max=[float(w.abs().max()) for w in want], controls=controls)
  require(launches == 1 and ok and all(c["refused"] for c in controls.values())
          and all(float(w.abs().max()) > 0 for w in want),
          f"grad-kernels {name}: {record}")
  return record


def check_kernel_gradients():
  """grad-kernels: the gradients through K1, K2, K2b, K3, K4, X, K6 and K6f
  at the shapes of train-bootstapir-256's step (batch 8 x 24 frames at
  256x256, 32 queries a chunk: K1, K2, K2b at its three pyramid grids, K3
  and K4 on [8 * 32, 24, 512], X, K6, K6f on the 32x32x256 ExtraConvs grid
  of 192 frames), float32, and K1, K3 in bfloat16 too. cuDNN in its
  deterministic mode, so the plain convolutions' backward repeats itself."""
  gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  records = []
  try:
    for dtype in (torch.float32, torch.bfloat16):
      for h, w, c in GRAD_CORR_LEVELS:
        args = corr_inputs(h, w, c, dtype, gen, bt=GRAD_BT, n=TRAIN_TAPIR_CHUNK)
        modes = ((False, "corr_tents"), ("per_frame", "corr_tents_q8_frame"),
                 (True, "corr_tents_q8_position"))
        for quantized, counter in modes[:1 if dtype == torch.bfloat16 else 3]:
          records.append(grad_case(
              f"{counter} {h}x{w}x{c}", dtype, args,
              lambda *a, q=quantized: corr_tents.corr_tent_patches(*a, 7, q),
              lambda *a, q=quantized: corr_tents._forward(*a, 7, q),  # pylint: disable=protected-access
              lambda *a: corr_tents.corr_tent_patches_reference(*a, 7),
              counter, gen))
        del args
      args = mixer_inputs(dtype, gen, GRAD_MIXER_SHAPE)
      for quantized, counter in ((False, "mixer_block"), (True, "mixer_block_q8")):
        if quantized and dtype == torch.bfloat16:
          continue
        records.append(grad_case(
            counter, dtype, args,
            lambda *a, q=quantized: fused_mixer_block.mixer_block(
                *a, quantized=q),
            lambda *a, q=quantized: fused_mixer_block._forward(  # pylint: disable=protected-access
                *a, False, None, q, None),
            lambda *a: fused_mixer_block.mixer_block_reference(*a),
            counter, gen))
      del args
    h, w = GRAD_EXTRA_GRID
    x, g, bln, wu, bu, wo, bo = extra_convs_inputs(h, w, torch.float32, gen)
    x = x[:GRAD_BT].contiguous()
    layer = (x, g, bln, wu, bu, wo, bo)
    for quantized, counter in ((False, "extra_convs_fp"),
                               (True, "extra_convs_q8_pixel")):
      records.append(grad_case(
          counter, torch.float32, layer,
          lambda *a, q=quantized: fused_extra_convs.extra_convs_layer(*a, q),
          lambda *a, q=quantized: fused_extra_convs._forward(*a, q, None),  # pylint: disable=protected-access
          lambda *a: fused_extra_convs.extra_convs_layer_reference(*a),
          counter, gen))
    xc = x.permute(0, 3, 1, 2)
    wk = wu.permute(3, 2, 0, 1).contiguous()
    records.append(grad_case(
        "extra_convs_q8_frame", torch.float32, (xc, wk, bu),
        qconv.conv2d_q8,
        lambda *a: qconv._forward(*a, None),  # pylint: disable=protected-access
        qconv.conv2d_fp_math, "extra_convs_q8_frame", gen))
  finally:
    torch.backends.cudnn.deterministic = deterministic
  torch.cuda.empty_cache()
  return records



def check_kernels():
  """Each kernel against its plain version on the same inputs, timed. Returns
  one record per check, and per kernel and dtype a `path` record: what one
  launch on the served path costs (corr-tents: the mean over the three
  pyramid levels, which each refinement step calls once each). K1 and K3
  are held at the online paths' shapes as well."""
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  checks = []
  for dtype in (torch.bfloat16, torch.float32):
    check_corr(dtype, gen, checks)
    check_mixer(dtype, gen, checks)
    # K3 with causal=True: the offline causal run's shape and the served one.
    check_mixer(dtype, gen, checks, OFFLINE_CAUSAL_MIXER_SHAPE, causal=True)
    check_mixer(dtype, gen, checks, causal=True)
    check_mixer_q8(dtype, gen, checks)
    check_conv_q8(dtype, gen, checks)
    check_extra_convs_q8(dtype, gen, checks)
    check_extra_convs_fp(dtype, gen, checks)
  check_scan(gen, checks)
  check_scan_backward(gen, checks)
  checks.extend(check_kernel_gradients())
  return checks


KERNEL_META = {
    "corr_tents": dict(
        source="tapnet_tpu_torch/csrc/corr_tents.cu",
        replaces="tapnet_tpu/ops/corr_tents.py:182",
        tpu_kernel="K1 corr_tents._kernel (via _pallas_forward :243)",
        layer="K1/K2 corr_tents", run="serve",
        # RoboTAP's dense stream: 1024 queries, 12 launches a frame.
        also_runs=("robotap_dense_256",),
    ),
    "corr_tents_q8_frame": dict(
        source="tapnet_tpu_torch/csrc/corr_tents.cu",
        replaces="tapnet_tpu/ops/corr_tents.py:266",
        tpu_kernel="K2 corr_tents._kernel :182 with frame_scale "
                   "(_pallas_forward :266, corr_tent_patches_prequantized :390)",
        layer="K1/K2 corr_tents", run="serve_int8",
        also_runs=("serve_headline",),
    ),
    "corr_tents_q8_position": dict(
        source="tapnet_tpu_torch/csrc/corr_tents.cu",
        replaces="tapnet_tpu/ops/corr_tents.py:239",
        tpu_kernel="K2b corr_tents._kernel_quantized (quantized=True, "
                   "_pallas_forward :292), on a grid quantized once per "
                   "video (corr_tent_patches_prequantized_per_position)",
        layer="K1/K2 corr_tents", run="serve_int8_b",
    ),
    # The per-position grids' quantizer (once per video), which JAX leaves
    # to XLA; K2 and K2b quantize their queries inside the kernel.
    "corr_quantize": dict(
        source="tapnet_tpu_torch/csrc/corr_tents.cu",
        replaces="tapnet_tpu/ops/corr_tents.py:62",
        tpu_kernel="corr_tents._quantize_lastdim (XLA, no Pallas kernel) on "
                   "K2b's grid (:299); the queries' (:271, :300) are "
                   "quantized inside K2 and K2b",
        layer="K1/K2 corr_tents", run="serve_int8_b",
    ),
    "mixer_block": dict(
        source="tapnet_tpu_torch/csrc/fused_mixer_block.cu",
        replaces="tapnet_tpu/ops/fused_mixer_block.py:256",
        tpu_kernel="K3 fused_mixer_block._kernel (via _pallas_forward :318)",
        layer="K3/K4 mixer_block", run="serve",
        loop="tapnet_tpu_torch/csrc/tma_gemm.cuh (the two bf16 products, "
             "mixer_gemm_tma)",
    ),
    # K3 and K1 in the predictor's default float32 (serve-480-fp32).
    "mixer_block_fp32": dict(
        counter="mixer_block", dtype="float32",
        source="tapnet_tpu_torch/csrc/fused_mixer_block.cu",
        replaces="tapnet_tpu/ops/fused_mixer_block.py:256",
        tpu_kernel="K3 fused_mixer_block._kernel (via _pallas_forward :318), "
                   "float32",
        layer="K3/K4 mixer_block", run="serve_fp32",
        loop="tapnet_tpu_torch/csrc/tma_gemm.cuh (the two float32 products "
             "as error-compensated TF32, tg::Tf32x3, mixer_gemm_tma)",
    ),
    "corr_tents_fp32": dict(
        counter="corr_tents", dtype="float32",
        source="tapnet_tpu_torch/csrc/corr_tents.cu",
        replaces="tapnet_tpu/ops/corr_tents.py:182",
        tpu_kernel="K1 corr_tents._kernel (via _pallas_forward :243), float32",
        layer="K1/K2 corr_tents", run="serve_fp32",
    ),
    "mixer_block_q8": dict(
        source="tapnet_tpu_torch/csrc/fused_mixer_block.cu",
        replaces="tapnet_tpu/ops/fused_mixer_block.py:187",
        tpu_kernel="K4 fused_mixer_block._kernel :256 with quantized=True "
                   "(_mlp_operand :187, _mlp_hidden :212, _mlp_epilogue :225)",
        layer="K3/K4 mixer_block", run="serve_int8",
        also_runs=("serve_headline",),
        loop="tapnet_tpu_torch/csrc/q8_tile.cuh (mixer_mlp_q8)",
    ),
    "extra_convs_q8_frame": dict(
        source="tapnet_tpu_torch/csrc/extra_convs.cu",
        replaces="tapnet_tpu/ops/qconv.py:46",
        tpu_kernel="(X) qconv.conv2d_q8_math, XLA's int8 convolution (no "
                   "Pallas kernel), per-frame scales",
        layer="int8 ExtraConvs (X, K6)", run="serve_headline",
        loop="tapnet_tpu_torch/csrc/tma_gemm.cuh (conv3x3_q8_tma)",
    ),
    "extra_convs_q8_pixel": dict(
        source="tapnet_tpu_torch/csrc/extra_convs.cu",
        replaces="tapnet_tpu/ops/fused_extra_convs.py:187",
        tpu_kernel="K6 fused_extra_convs._kernel with quantized=True (via "
                   "_pallas_forward :261)",
        layer="int8 ExtraConvs (X, K6)", run="serve_int8_pp",
        loop="tapnet_tpu_torch/csrc/q8_tile.cuh (k6_conv_up, k6_conv_out)",
    ),
    # No model path reaches K6f (JAX's gate demands the per-pixel mode): its
    # run is the trained ExtraConvs stack at the served grids.
    "extra_convs_fp": dict(
        source="tapnet_tpu_torch/csrc/extra_convs.cu",
        replaces="tapnet_tpu/ops/fused_extra_convs.py:187",
        tpu_kernel="K6f fused_extra_convs._kernel with quantized=False "
                   "(:233-237, operands :294-297; via _pallas_forward :261, "
                   "entry extra_convs_layer :336)",
        layer="K6f float ExtraConvs", run="extra_convs_fp_480",
        loop="tapnet_tpu_torch/csrc/tma_gemm.cuh (bf16: conv3x3_bf16_tma; "
             "fp32: split_tf32, conv3x3_tf32x3_tma, error-compensated TF32)",
    ),
    # TAPNext: the scan's inputs stay float32 in the served bf16 model.
    "linear_scan": dict(
        source="tapnet_tpu_torch/csrc/scan.cu",
        replaces="tapnet_tpu/ops/scan.py:32",
        tpu_kernel="K5 scan._scan_kernel (via _scan_pallas :83, entry "
                   "linear_scan :159)",
        layer="K5 linear_scan", run="serve_tapnext", dtype="float32",
    ),
    # K5's backward, on the training path (fp32, as JAX trains TAPNext).
    "linear_scan_backward": dict(
        source="tapnet_tpu_torch/csrc/scan.cu",
        replaces="tapnet_tpu/ops/scan.py:193",
        tpu_kernel="K5b scan._scan_bwd (launches _scan_pallas on reversed "
                   "time at :211)",
        layer="K5b linear_scan_backward", run="train_tapnext_256",
        dtype="float32", per="step",
    ),
}


# ---------------------------------------------------------------- main path


def golden_errors(predictor, out, golden):
  """Track and logit errors of one golden run against the JAX outputs."""
  err = np.linalg.norm(out["tracks"] - golden["tracks"], axis=-1)
  return dict(
      track_max_px=float(np.abs(out["tracks"] - golden["tracks"]).max()),
      track_median_px=float(np.median(err)),
      track_p95_px=float(np.percentile(err, 95)),
      logit_max_abs=max(float(np.abs(out[k] - golden[k]).max())
                        for k in ("occlusion", "expected_dist")),
      visible_agree=float(np.mean(
          predictor.visibles(out) == predictor.visibles(dict(golden)))),
  )


def within_fp32(r):
  return (r["track_max_px"] <= GOLDEN_FP32_TOL["tracks"]
          and r["logit_max_abs"] <= GOLDEN_FP32_TOL["logits"])


def within_bf16(r):
  tol = GOLDEN_BF16_TOL
  return (r["track_median_px"] <= tol["median_px"]
          and r["track_p95_px"] <= tol["p95_px"]
          and r["visible_agree"] >= tol["visible_agree"])


def golden_check(params):
  """The golden clip in fp32 (TF32 off) and bf16 against the JAX golden
  outputs, then the predictor's default float32 once more at PyTorch's own
  TF32 settings (cuDNN on, matmul off), as `serve` and every user of
  `TapirPredictor(bfloat16=False)` run it: its error is printed against the
  fp32 and the bf16 limits, and it must stay within the bf16 ones (TF32
  keeps 10 mantissa bits, bf16 7)."""
  golden = np.load(GOLDEN)
  frames = preprocess_frames(torch.from_numpy(golden["video"]))
  result = {}
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  for bf16 in (False, True):
    predictor = TapirPredictor(params, bootstapir_config(), bfloat16=bf16)
    out = predictor(frames, golden["query_points"])
    key = "bf16" if bf16 else "fp32"
    r = result[key] = golden_errors(predictor, out, golden)
    if bf16:
      require(within_bf16(r), f"bf16 golden check failed: {r} vs {GOLDEN_BF16_TOL}")
    else:
      require(within_fp32(r), f"fp32 golden check failed: {r} vs {GOLDEN_FP32_TOL}")
    del predictor
  torch.backends.cudnn.allow_tf32 = True
  predictor = TapirPredictor(params, bootstapir_config())
  out = predictor(frames, golden["query_points"])
  r = result["fp32_tf32_defaults"] = dict(
      golden_errors(predictor, out, golden),
      tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                cudnn=torch.backends.cudnn.allow_tf32))
  r.update(within_fp32_limits=within_fp32(r), within_bf16_limits=within_bf16(r))
  print(f"golden fp32 at PyTorch's TF32 defaults (cuDNN on, matmul off): "
        f"track max {r['track_max_px']:.4g} px, median {r['track_median_px']:.4g}, "
        f"p95 {r['track_p95_px']:.4g}, logits {r['logit_max_abs']:.4g}, flags "
        f"{r['visible_agree']:.4f}; fp32 limits {GOLDEN_FP32_TOL}: "
        f"{'within' if r['within_fp32_limits'] else 'over'}; bf16 limits "
        f"{GOLDEN_BF16_TOL}: {'within' if r['within_bf16_limits'] else 'over'}",
        flush=True)
  require(r["within_bf16_limits"],
          f"fp32 golden check at the TF32 defaults failed: {r} vs {GOLDEN_BF16_TOL}")
  del predictor
  return result


def golden_check_int8(params):
  """The int8 configurations on their golden clips (the 8-frame clip, or
  the longer clip rebuilt from the tool's seed), in fp32 and bf16 model
  dtype, against the JAX int8 golden outputs. Returns the records and the
  kernels' launch counts of each run."""
  golden = np.load(GOLDEN)
  golden_int8 = np.load(GOLDEN_INT8)
  result, launches, failed = {}, {}, []
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  for name, overrides in INT8_CONFIGS.items():
    ref = {k[2:]: v for k, v in golden_int8.items() if k.startswith(name + "_")}
    if CLIP_FRAMES[name] == golden["video"].shape[1]:
      video, query_points = golden["video"], golden["query_points"]
    else:
      video, query_points = make_clip(num_frames=CLIP_FRAMES[name])
    frames = preprocess_frames(torch.from_numpy(video))
    for bf16 in (False, True):
      predictor = TapirPredictor(
          params, bootstapir_config(**overrides), bfloat16=bf16)
      reset_counts()
      out = predictor(frames, query_points)
      counts = read_counts()
      key = f"{name}_{'bf16' if bf16 else 'fp32'}"
      launches[key] = counts
      expected = INT8_LAUNCHES[name]
      require({k for k, v in counts.items() if v} == expected,
              f"int8 golden {key}: launches {counts}, expected {expected}")
      err = np.linalg.norm(out["tracks"] - ref["tracks"], axis=-1)
      visible = predictor.visibles(ref)
      r = result[key] = dict(
          track_visible_max_px=float(err[visible].max()),
          track_max_px=float(err.max()),
          track_median_px=float(np.median(err)),
          track_p95_px=float(np.percentile(err, 95)),
          logit_max_abs=max(float(np.abs(out[k] - ref[k]).max())
                            for k in ("occlusion", "expected_dist")),
          visible_agree=float(np.mean(predictor.visibles(out) == visible)),
      )
      if bf16:
        tol = GOLDEN_BF16_TOL
        ok = (r["track_median_px"] <= tol["median_px"]
              and r["track_p95_px"] <= tol["p95_px"]
              and r["visible_agree"] >= tol["visible_agree"])
      else:
        tol = GOLDEN_INT8_FP32_TOL[name]
        ok = (r["track_visible_max_px"] <= tol["visible_px"]
              and r["track_max_px"] <= tol["any_px"]
              and r["track_median_px"] <= tol["median_px"]
              and r["logit_max_abs"] <= tol["logits"])
      if not ok:
        failed.append(f"{key}: {r} vs {tol}")
      del predictor
  torch.backends.cudnn.allow_tf32 = True
  require(not failed, "int8 golden check failed: " + "; ".join(failed))
  return result, launches


def make_videos(count, queries=QUERIES, num_frames=FRAMES):
  """Textured 480x480 clips of `num_frames` on the device: the golden clip's
  frames, upsampled and scrolled a few pixels per frame, one direction per
  video, with `queries` query points each."""
  golden = np.load(GOLDEN)
  base = torch.from_numpy(golden["video"][0]).cuda().permute(0, 3, 1, 2).float()
  base = torch.nn.functional.interpolate(base, size=(RES, RES), mode="bilinear")
  gen = torch.Generator(device="cpu").manual_seed(SEED)
  videos = []
  for k in range(count):
    vy, vx = (torch.randint(-3, 4, (2,), generator=gen)).tolist()
    frames = torch.stack([
        torch.roll(base[t % base.shape[0]], (vy * t, vx * t), dims=(1, 2))
        for t in range(num_frames)
    ])
    video = frames.permute(0, 2, 3, 1)[None] / 255.0 * 2.0 - 1.0
    qp = torch.stack([
        torch.randint(0, num_frames, (queries,), generator=gen).float(),
        torch.rand(queries, generator=gen) * (RES - 16) + 8,
        torch.rand(queries, generator=gen) * (RES - 16) + 8,
    ], -1)[None]
    videos.append((video, qp.numpy()))
  return videos


# Kernel-name fragments per layer, for the profile's breakdown; a kernel
# counts in the first layer it matches.
EXTRA_KERNELS = ("conv3x3_q8_tma", "frame_amax", "quantize_frames",
                 "ln_bias_rows", "patch_scale", "k6_conv_up", "k6_conv_out")
LAYERS = (
    ("K1/K2 corr_tents", ("corr_tents_kernel", "corr_tents_q8_kernel",
                          "corr_quantize_rows")),
    ("K3/K4 mixer_block", ("mixer_temporal", "mixer_gemm_tma", "split_tf32",
                           "mixer_mlp_q8")),
    ("int8 ExtraConvs (X, K6)", EXTRA_KERNELS),
    ("convolutions (cuDNN, with its layout transforms)",
     ("conv", "fprop", "nchwtonhwc", "nhwctonchw")),
    ("matmuls (cuBLAS)", ("gemm", "cutlass", "cublas")),
)


OWN_KERNELS = ("mixer_", "split_tf32", "corr_tents", "corr_quantize", "conv3x3_bf16",
               "conv3x3_tf32x3", "ln_bias_slab") + EXTRA_KERNELS


def profile_request(request, unprofiled_wall_s, layers=LAYERS, own=OWN_KERNELS,
                    top=10):
  """Kernel time of one request (a call of `request`) by layer and by name
  (torch.profiler's device timestamps), and the device's busy share of the
  unprofiled wall time of a request (the profiler slows the host, not the
  kernels). A kernel counts in the first of `layers` its name matches."""
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    request()
  kernels = []
  for e in prof.key_averages():
    if not str(e.device_type).endswith("CUDA"):
      continue
    dev_us = getattr(e, "self_device_time_total", None)
    if dev_us is None:
      dev_us = e.self_cuda_time_total
    kernels.append((dev_us / 1e3, e.count, e.key))
  kernels.sort(reverse=True)
  device_ms = sum(k[0] for k in kernels)
  other = "other (elementwise, reductions, copies)"
  by_layer = {name: 0.0 for name, _ in layers}
  by_layer[other] = 0.0
  for ms, _, name in kernels:
    layer = next((lay for lay, keys in layers
                  if any(k in name.lower() for k in keys)), other)
    by_layer[layer] += ms
  return dict(
      device_ms=device_ms,
      device_busy_share=device_ms / (unprofiled_wall_s * 1e3),
      by_layer_ms=by_layer,
      own_kernels=[dict(name=name.replace("(anonymous namespace)::", "")[:60],
                        ms=ms, calls=calls)
                   for ms, calls, name in kernels
                   if any(k in name for k in own)],
      top=[dict(name=name[:100], ms=ms, calls=calls)
           for ms, calls, name in kernels[:top]],
  )


def serve(params, videos, overrides, launched, queries=QUERIES,
          bfloat16=True):
  """Serves videos[1:] after a warm-up request on videos[0], in bf16 (or,
  with bfloat16=False, in the predictor's default float32, with PyTorch's
  TF32 settings at their defaults) with `overrides` of bootstapir_config().
  `launched` names the kernels this configuration must launch, equally often
  per video; every other kernel's count must stay 0."""
  count = len(videos) - 1
  # PyTorch's defaults: float32 matmuls in full float32, cuDNN in TF32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = True
  predictor = TapirPredictor(
      params, bootstapir_config(**overrides), bfloat16=bfloat16,
      query_chunk_size=CHUNK, refinement_resolutions=[(RES, RES)],
  )
  # Warm-up request: cuDNN algorithm choice and allocator growth.
  predictor(*videos[0])
  torch.cuda.synchronize()
  reset_counts()
  torch.cuda.reset_peak_memory_stats()
  start = time.perf_counter()
  outs = list(predictor.track_many(videos[1:]))
  wall = time.perf_counter() - start
  launches = read_counts()
  peak = torch.cuda.max_memory_allocated()
  require(len(outs) == count, f"track_many yielded {len(outs)} of {count}")
  require(all(v % count == 0 for v in launches.values()),
          f"launches differ between equal requests: {launches}")
  for out in outs:
    require(out["tracks"].shape == (1, queries, FRAMES, 2),
            f"tracks shape {out['tracks'].shape}")
    for key in ("tracks", "occlusion", "expected_dist"):
      require(np.isfinite(out[key]).all(), f"non-finite {key}")
    require(np.abs(out["tracks"]).max() < 4 * RES, "tracks far off the frame")
  require({k for k, v in launches.items() if v > 0} == set(launched),
          f"launched {launches}, expected exactly {sorted(launched)}")
  return dict(config=overrides, dtype="bfloat16" if bfloat16 else "float32",
              tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                        cudnn=torch.backends.cudnn.allow_tf32),
              videos=count, frames=FRAMES, queries=queries,
              chunk=CHUNK, resolution=RES, wall_s_total=wall,
              wall_s_per_video=wall / count, peak_memory_bytes=peak,
              launches_per_video={k: v // count for k, v in launches.items()},
              visible_frac=[float(predictor.visibles(o).mean()) for o in outs],
              tracks=[o["tracks"] for o in outs],
              profile=profile_request(lambda: predictor(*videos[1]),
                                      wall / count))


def tracks_apart(a, b):
  """Median and 95th percentile distance in px between two runs' tracks."""
  d = np.concatenate([np.linalg.norm(x - y, axis=-1).ravel()
                      for x, y in zip(a, b)])
  return dict(median_px=float(np.median(d)), p95_px=float(np.percentile(d, 95)))


def extra_convs_fp_480(params, videos):
  """extra-convs-fp-480: the trained model's five ExtraConvs layers, as K6f
  (`extra_convs_layer(quantized=False)`), on the backbone activations of
  served 480x480 videos at both grids (the backbone at 256x256 and
  480x480, bf16), after a warm-up on videos[0]: 10 launches per video. Each
  K6f layer is held against the model's unfused float layer on the same
  input within fp_error_limit(unfused=True); the two stacks are timed, and
  the K6f stack profiled."""
  predictor = TapirPredictor(params, bootstapir_config(), bfloat16=True)
  model = predictor.model
  extra = model.extra
  weights = []
  for i in range(extra.num_layers):
    ln = getattr(extra, f"ln_{i}")
    up, down = getattr(extra, f"conv_up_{i}"), getattr(extra, f"conv_out_{i}")
    weights.append((ln.scale, ln.bias, up.weight.permute(2, 3, 1, 0), up.bias,
                    down.weight.permute(2, 3, 1, 0), down.bias))

  def activations(video):
    """The ExtraConvs' inputs [T, 256, h, w] (NCHW views) at both grids."""
    frames = video.to(torch.bfloat16)
    out = []
    for res in ((256, 256), (RES, RES)):
      resized = resize_video(frames, res)[0].permute(0, 3, 1, 2)
      out.append(model.backbone(resized)["group_3"])
    return out

  def k6f_stack(x):
    y = x.permute(0, 2, 3, 1).contiguous()
    for w in weights:
      y = fused_extra_convs.extra_convs_layer(y, w[0], w[1], w[2], w[3], w[4],
                                              w[5], False)
    return y

  def layer_by_layer(x):
    """Each K6f layer against the unfused layer on the stack's own input;
    and the faulty plain layer that lets the pad ring's hidden through
    (fp_output_controls' unmasked_pad), on the first K6_CONTROL_FRAMES
    frames, which the same limit must refuse."""
    worst, control = 0.0, float("inf")
    y = x.permute(0, 2, 3, 1).contiguous()
    k = K6_CONTROL_FRAMES
    for i, w in enumerate(weights):
      nxt = fused_extra_convs.extra_convs_layer(y, *w, False)
      one = production_extra_convs(*(v.float() for v in w), torch.bfloat16)
      prod = one(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
      limit = fused_extra_convs.fp_error_limit(y, *w, unfused=True)
      over = float(((nxt.float() - prod.float()).abs()
                    / limit.clamp_min(1e-30)).max())
      require(over <= 1.0, f"extra-convs-fp-480 layer {i}: {over} of its limit")
      faulty = fused_extra_convs.fp_output_controls(y[:k], *w)["unmasked_pad"]
      refused = float(((faulty.float() - prod[:k].float()).abs()
                       / limit[:k].clamp_min(1e-30)).max())
      require(refused > 1.0, f"extra-convs-fp-480 layer {i}: the unfused "
              f"limit passes the unmasked pad ({refused} of it)")
      worst, control = max(worst, over), min(control, refused)
      y = nxt
    return y, worst, control

  with torch.inference_mode():
    grids = activations(videos[0][0])
    for x in grids:  # warm-up
      k6f_stack(x)
      extra(x)
    torch.cuda.synchronize()
    reset_counts()
    per_video, outs = [], []
    for video, _ in videos[1:]:
      grids = activations(video)
      torch.cuda.synchronize()
      begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      begin.record()
      outs.append([k6f_stack(x) for x in grids])
      end.record()
      torch.cuda.synchronize()
      per_video.append(begin.elapsed_time(end))
    launches = read_counts()
    count = len(videos) - 1
    require(launches["extra_convs_fp"] == 2 * extra.num_layers * count
            and sum(launches.values()) == launches["extra_convs_fp"],
            f"extra-convs-fp-480: launches {launches}")
    production_ms = [time_ms(lambda x=x: extra(x), reps=3) for x in grids]
    k6f_ms = [time_ms(lambda x=x: k6f_stack(x), reps=3) for x in grids]
    held, refused, apart = {}, {}, {}
    for x, y, res in zip(grids, outs[-1], ("256", str(RES))):
      _, held[res], refused[res] = layer_by_layer(x)
      prod = extra(x).permute(0, 2, 3, 1).float()
      d = (y.float() - prod).abs()
      apart[res] = dict(max_abs=float(d.max()), median_abs=float(d.median()),
                        out_max_abs=float(prod.abs().max()))
    for y in outs[-1]:
      require(bool(torch.isfinite(y.float()).all()), "extra-convs-fp-480: non-finite")
    profile = profile_request(
        lambda: [k6f_stack(x) for x in grids], float(np.mean(per_video)) / 1e3,
        layers=(("K6f float ExtraConvs", ("conv3x3_bf16", "conv3x3_tf32x3",
                                          "ln_bias_slab")),)
        + LAYERS)
  return dict(
      config="bootstapir_config(), bf16 model, trained weights", videos=count,
      frames=FRAMES, grids=[[256 // 8] * 2, [RES // 8] * 2],
      k6f_stack_event_ms_per_video=per_video,
      k6f_stack_ms_per_grid=dict(zip(("256", str(RES)), k6f_ms)),
      production_stack_ms_per_grid=dict(zip(("256", str(RES)), production_ms)),
      per_layer_max_err_over_limit=held,
      unmasked_pad_min_err_over_limit=refused,
      limit="fused_extra_convs.fp_error_limit(unfused=True), per element, "
            "each layer on the K6f stack's own input",
      stack_output_vs_production=apart,
      launches_per_video={k: v // count for k, v in launches.items()},
      profile=profile)


def online_golden_check(params):
  """online-golden: the trained causal BootsTAPIR through
  OnlineTapirPredictor on the golden clip (the protocol of
  tools/make_online_golden.run_stream: init on frame 0, a step per frame,
  add_points at frame 4) against the JAX stream, fp32 (TF32 off) and bf16;
  then the stream without add_points against the port's offline causal
  model on the whole clip."""
  golden = np.load(GOLDEN_ONLINE)
  frames = preprocess_frames(torch.from_numpy(np.load(GOLDEN)["video"])).numpy()
  qp, new_qp = golden["query_points"], golden["new_query_points"]
  steps = frames.shape[1]
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  result, failed = {}, []

  def judge(key, r, bf16):
    tol = GOLDEN_BF16_TOL if bf16 else GOLDEN_FP32_TOL
    ok = (r["track_median_px"] <= tol["median_px"]
          and r["track_p95_px"] <= tol["p95_px"]
          and r["visible_agree"] >= tol["visible_agree"]) if bf16 else (
              r["track_max_px"] <= tol["tracks"]
              and r["logit_max_abs"] <= tol["logits"])
    if not ok:
      failed.append(f"{key}: {r} vs {tol}")

  def apart(tracks, ref_tracks, logits, ref_logits, visibles, ref_visibles):
    err = np.linalg.norm(tracks - ref_tracks, axis=-1)
    return dict(
        track_max_px=float(np.abs(tracks - ref_tracks).max()),
        track_median_px=float(np.median(err)),
        track_p95_px=float(np.percentile(err, 95)),
        logit_max_abs=max(float(np.abs(a - b).max())
                          for a, b in zip(logits, ref_logits)),
        visible_agree=float(np.mean(visibles == ref_visibles)))

  for name in ("float32", "bfloat16"):
    bf16 = name == "bfloat16"
    predictor = OnlineTapirPredictor(
        params, causal_bootstapir_config(compute_dtype=name))
    reset_counts()
    out = run_stream(predictor.init, predictor.step, predictor.add_points,
                     frames, qp, new_qp)
    counts = read_counts()
    require(counts["corr_tents"] == ONLINE_K1_PER_STEP * steps
            and sum(counts.values()) == counts["corr_tents"],
            f"online-golden {name}: launches {counts}")
    r = result[name] = apart(
        out["tracks"], golden[f"{name}_tracks"],
        [out["occlusion"], out["expected_dist"]],
        [golden[f"{name}_occlusion"], golden[f"{name}_expected_dist"]],
        out["visibles"], golden[f"{name}_visibles"])
    r["k1_launches_per_step"] = counts["corr_tents"] / steps
    judge(f"stream vs JAX {name}", r, bf16)

    # The stream (no add_points) against the offline causal model.
    predictor.init(frames[:, 0], qp)
    stream = [predictor.step(frames[:, t]) for t in range(steps)]
    model = predictor.model
    p = model.config.num_pips_iter
    with torch.inference_mode():
      video = torch.from_numpy(frames).cuda()
      grids = model.get_feature_grids(video)
      qf = model.get_query_features(video.shape, torch.from_numpy(qp).cuda(),
                                    grids)
      reset_counts()
      offline = model.estimate_trajectories(tuple(video.shape[2:4]), grids, qf,
                                            None)
      counts = read_counts()
    mean = lambda key: torch.stack(offline[key][p::p]).mean(0).cpu()
    occ, expd = mean("occlusion"), mean("expected_dist")
    vis = postprocess_occlusions(occ, expd).numpy()
    occ, expd = occ.numpy(), expd.numpy()
    take = lambda key: np.stack([o[key] for o in stream], 2)  # [B, N, T, ...]
    r = result[f"{name}_stream_vs_offline"] = apart(
        take("tracks"), mean("tracks").numpy(),
        [take("occlusion"), take("expected_dist")], [occ, expd],
        take("visibles"), vis)
    r["offline_launches"] = counts
    require(counts["mixer_block"] == p * model.config.num_mixer_blocks
            and counts["corr_tents"] == ONLINE_K1_PER_STEP,
            f"offline causal run {name}: launches {counts}")
    judge(f"stream vs offline {name}", r, bf16)
    del predictor, model, video, grids, qf, offline
    torch.cuda.empty_cache()
  torch.backends.cudnn.allow_tf32 = True
  require(not failed, "online golden check failed: " + "; ".join(failed))
  return result


# online-golden-int8's measures: limit name -> `stream_apart` key.
_STREAM_MEASURES = dict(visible_px="track_visible_max_px",
                        any_px="track_max_px", median_px="track_median_px",
                        logits="logit_max_abs")
_STREAM_KEYS = ("tracks", "visibles", "occlusion", "expected_dist")


def stream_apart(out, ref, keep=slice(None)):
  """Distances of stream `out` from `ref` ([T, B, N] arrays by
  _STREAM_KEYS, B = 1) on the queries `keep`."""
  out = {k: v[:, :, keep] for k, v in out.items()}
  ref = {k: v[:, :, keep] for k, v in ref.items()}
  err = np.linalg.norm(out["tracks"] - ref["tracks"], axis=-1)
  visible = ref["visibles"]
  return dict(
      track_visible_max_px=float(err[visible].max()),
      track_max_px=float(err.max()),
      track_median_px=float(np.median(err)),
      track_p95_px=float(np.percentile(err, 95)),
      logit_max_abs=max(float(np.abs(out[k] - ref[k]).max())
                        for k in ("occlusion", "expected_dist")),
      visible_agree=float(np.mean(out["visibles"] == visible)))


def stream_within(r, tol):
  return all(r[m] <= tol[k] for k, m in _STREAM_MEASURES.items())


def off_track(out, ref, tol):
  """The queries whose track leaves `tol`'s track limits at some step."""
  err = np.linalg.norm(out["tracks"] - ref["tracks"], axis=-1)[:, 0]
  return np.nonzero((err > tol["any_px"]).any(0)
                    | ((err > tol["visible_px"]) & ref["visibles"][:, 0])
                    .any(0))[0]


def online_int8_limits(golden, name):
  """(limits, witness) of int8 stream `name`: the witness is JAX's stream on
  the nudged clip against JAX's stream, on the queries that stay within the
  offline limits (its `off_track` queries listed apart); each limit is the
  offline one or ONLINE_INT8_WITNESS x the witness's distance, whichever is
  larger."""
  ref = {k: golden[f"{name}_{k}"] for k in _STREAM_KEYS}
  nudged = {k: golden[f"{name}_nudged_{k}"] for k in _STREAM_KEYS}
  offline = GOLDEN_INT8_FP32_TOL[name]
  flipped = off_track(nudged, ref, offline)
  keep = np.setdiff1d(np.arange(ref["tracks"].shape[2]), flipped)
  witness = dict(stream_apart(nudged, ref, keep),
                 flipped=[int(q) for q in flipped])
  limits = {k: max(offline[k], ONLINE_INT8_WITNESS * witness[m])
            for k, m in _STREAM_MEASURES.items()}
  return limits, witness


def online_int8_clips():
  """The int8 streams' witness clips: (name, JAX's int8 streams and their
  witness, the preprocessed frames, JAX's float32 stream on them). The
  golden clip, and the second clip of tools/make_online_golden.py."""
  float_golden = np.load(GOLDEN_ONLINE)
  clip2 = np.load(GOLDEN_ONLINE_INT8_CLIP2)
  require(int(clip2["seed"]) == CLIP2_SEED, "second clip: seed mismatch")
  frames = lambda video: preprocess_frames(torch.from_numpy(video)).numpy()
  return [
      ("golden_clip", np.load(GOLDEN_ONLINE_INT8),
       frames(np.load(GOLDEN)["video"]),
       {k: float_golden[f"float32_{k}"] for k in _STREAM_KEYS}),
      ("second_clip", clip2, frames(make_clip(CLIP2_SEED)[0]),
       {k: clip2[f"float32_{k}"] for k in _STREAM_KEYS}),
  ]


def online_golden_check_int8(params):
  """online-golden-int8: the trained causal BootsTAPIR in the int8
  configurations a-d (fp32 model dtype, TF32 off) through
  OnlineTapirPredictor on each witness clip's stream (`online_int8_clips`)
  against JAX's int8 streams, under `online_int8_limits` of that clip (the
  witness's near ties apart, and at most ONLINE_INT8_FLIPPED other queries,
  none of ADD_IDX, on their other stage-1 peak), which JAX's float stream
  on the clip must fail; each stream must launch its own kernels
  (ONLINE_INT8_LAUNCHES) and no other, with num_pips_iter x 3 grids of
  correlation launches a step."""
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  result, failed = {}, []
  for clip, golden, frames, float_ref in online_int8_clips():
    qp, new_qp = golden["query_points"], golden["new_query_points"]
    steps = frames.shape[1]
    for name, overrides in INT8_CONFIGS.items():
      config = causal_bootstapir_config(**overrides)
      predictor = OnlineTapirPredictor(params, config)
      reset_counts()
      out = run_stream(predictor.init, predictor.step, predictor.add_points,
                       frames, qp, new_qp)
      counts = read_counts()
      corr = next(k for k in ONLINE_INT8_LAUNCHES[name]
                  if k.startswith("corr_tents"))
      require({k for k, v in counts.items() if v} == ONLINE_INT8_LAUNCHES[name]
              and counts[corr] == 3 * config.num_pips_iter * steps,
              f"online-golden-int8 {clip} {name}: launches {counts}, "
              f"expected {sorted(ONLINE_INT8_LAUNCHES[name])}")
      ref = {k: golden[f"{name}_{k}"] for k in _STREAM_KEYS}
      tol, witness = online_int8_limits(golden, name)
      near_ties = witness["flipped"]
      # Other queries that left the track limits at some step.
      flipped = np.setdiff1d(off_track(out, ref, tol), near_ties)
      keep = np.setdiff1d(np.arange(ref["tracks"].shape[2]),
                          np.union1d(flipped, near_ties))
      err = np.linalg.norm(out["tracks"] - ref["tracks"], axis=-1)[:, 0]
      to_float = np.linalg.norm(out["tracks"] - float_ref["tracks"],
                                axis=-1)[:, 0]
      r = result.setdefault(clip, {})[name] = dict(
          stream_apart(out, ref, keep), tol=tol,
          offline_tol=GOLDEN_INT8_FP32_TOL[name], jax_nudged_witness=witness,
          all_queries=stream_apart(out, ref),
          flipped={int(q): dict(max_px_from_int8=float(err[:, q].max()),
                                max_px_from_float=float(to_float[:, q].max()))
                   for q in flipped},
          near_ties={int(q): float(err[:, q].max()) for q in near_ties},
          launches=counts,
          launches_per_step={k: v / steps for k, v in counts.items() if v})
      # Control: JAX's float stream, held to the same limits, must fail them.
      control = stream_apart(float_ref, ref, keep)
      r["float_stream_vs_int8"] = dict(control,
                                       refused=not stream_within(control, tol))
      if (len(flipped) > ONLINE_INT8_FLIPPED
          or (set(flipped) | set(near_ties)) & set(ADD_IDX)
          or not stream_within(r, tol) or stream_within(control, tol)):
        failed.append(f"{clip} {name}: {r} vs {tol}")
      del predictor
    if clip == "golden_clip":
      # A config-c step alone: K2 and X, and no K6.
      predictor = OnlineTapirPredictor(params, causal_bootstapir_config(
          **INT8_CONFIGS["c"]))
      predictor.init(frames[:, 0], qp)
      reset_counts()
      predictor.step(frames[:, 1])
      counts = read_counts()
      require(counts["corr_tents_q8_frame"] > 0
              and counts["extra_convs_q8_frame"] > 0
              and counts["extra_convs_q8_pixel"] == 0,
              f"a config-c step: launches {counts}")
      result["c_one_step_launches"] = counts
      del predictor
  torch.backends.cudnn.allow_tf32 = True
  require(not failed, "online golden int8 check failed: " + "; ".join(failed))
  return result


def online_tapir(params, config, per_step=None):
  """One online cell: 64 queries on frame 0 of a 256x256 clip, init, then
  ONLINE_WARMUP steps and ONLINE_STEPS timed steps (host clock around
  `predict`, which returns its tracks to the host); a 10-step profile.
  `per_step`: the launches a step must make, by counter (default 12 K1
  launches) and no other kernel."""
  per_step = per_step or {"corr_tents": ONLINE_K1_PER_STEP}
  online = OnlineTapirPredictor(params, config)
  (video, qp), = tapnext_videos(1, frames=ONLINE_WARMUP + ONLINE_STEPS + 1,
                                queries=ONLINE_QUERIES, query_t=0)
  online.init(video[:, 0], qp)
  for t in range(1, ONLINE_WARMUP + 1):
    online.predict(video[:, t])
  torch.cuda.synchronize()
  reset_counts()
  step_ms, tracks = [], []
  for t in range(ONLINE_WARMUP + 1, ONLINE_WARMUP + ONLINE_STEPS + 1):
    begin = time.perf_counter()
    tr, vis = online.predict(video[:, t])
    step_ms.append((time.perf_counter() - begin) * 1e3)
    tracks.append(tr)
  launches = read_counts()
  require({k: v for k, v in launches.items() if v}
          == {k: n * ONLINE_STEPS for k, n in per_step.items()},
          f"online TAPIR: launches {launches}, expected {per_step} per step "
          "and no other kernel")
  tracks = np.stack(tracks)
  require(tracks.shape == (ONLINE_STEPS, 1, ONLINE_QUERIES, 2)
          and np.isfinite(tracks).all() and np.abs(tracks).max() < 4 * TN_RES,
          "online TAPIR: bad tracks")
  mean_ms = float(np.mean(step_ms))
  profile = profile_request(
      lambda: [online.predict(video[:, t]) for t in range(1, 11)],
      mean_ms * 10 / 1e3, top=15)
  return dict(
      config=dict(causal=True, extra_convs=config.extra_convs,
                  compute_dtype=config.compute_dtype,
                  weights="runs/bootstapir_synth/trained_params_f16.npy"
                  + ("" if config.extra_convs else " without ExtraConvs")),
      queries=ONLINE_QUERIES, resolution=TN_RES, steps=ONLINE_STEPS,
      ms_per_frame_mean=mean_ms, ms_per_frame_median=float(np.median(step_ms)),
      ms_per_frame_min=float(np.min(step_ms)),
      launches_per_step={k: v / ONLINE_STEPS for k, v in launches.items() if v},
      launches=launches, profile_10_steps=profile,
      **({"mlp_q8": mlp_q8_step_ms(online.model)}
         if config.quantized_mixer else {}))


def mlp_q8_step_ms(model):
  """The streaming w8a8 channel MLP (`mixer_math.mlp_math_q8`, plain
  PyTorch, its int8 products as float64 matmuls) at an online step's shape
  [ONLINE_QUERIES, 1, hidden], timed with CUDA events: ms a call, and a
  step's share (a call per mixer block per refinement step)."""
  block = model.mixer.block_0
  w1q, s1, w2q, s2 = block.quantized_weights()
  x = torch.randn(ONLINE_QUERIES, 1, block.fc_up.in_features, device="cuda")
  with torch.inference_mode():
    ms = time_ms(lambda: mixer_math.mlp_math_q8(
        x, block.ln_channel.scale, w1q, s1, block.fc_up.bias, w2q, s2,
        block.fc_down.bias), reps=50, warmup=5)
  calls = model.config.num_mixer_blocks * model.config.num_pips_iter
  return dict(ms_per_call=ms, calls_per_step=calls, ms_per_step=ms * calls)


def eval_synth(params):
  """eval-synth: the held-out AJ of the trained BootsTAPIR on the card in
  every served precision (EVAL_RUNS), against JAX's metrics on the same
  videos and weights. Returns one record per run: the 13 mean metrics,
  JAX's, their gaps, the guard, the per-video AJ, the launches by kernel
  and the seconds."""
  with open(EVAL_JAX_METRICS) as f:
    ref = json.load(f)["runs"]
  result = {}
  try:
    begin = time.perf_counter()
    for name in sorted({s for s, _ in EVAL_RUNS}):
      spec = dict(synthetic.HELD_OUT_SETS[name])
      synthetic.export_npz(os.path.join(EVAL_DIR, name),
                           spec.pop("num_examples"),
                           draws=synthetic.load_draws(EVAL_DRAWS, name), **spec)
    result["rebuild_s"] = time.perf_counter() - begin
    torch.backends.cuda.matmul.allow_tf32 = False
    for set_name, precision in EVAL_RUNS:
      torch.backends.cudnn.allow_tf32 = precision == "tf32"
      predictor = TapirPredictor(
          params, bootstapir_config(**INT8_CONFIGS.get(precision, {})),
          query_chunk_size=synthetic.HELD_OUT_QUERY_CHUNK_SIZE,
          bfloat16=precision == "bf16")
      reset_counts()
      begin = time.perf_counter()
      per_video = [
          tapvid_evaluate.evaluate_dataset(
              predictor, [element], synthetic.HELD_OUT_QUERY_MODE,
              verbose=False)
          for element in tapvid_datasets.create_kubric_dataset(
              os.path.join(EVAL_DIR, set_name),
              synthetic.HELD_OUT_QUERY_MODE)]
      seconds = time.perf_counter() - begin
      counts = read_counts()
      require({k for k, v in counts.items() if v} == EVAL_LAUNCHES[precision],
              f"eval-synth {set_name}:{precision}: launches {counts}")
      jax_key = f"{set_name}:{'fp32' if precision == 'tf32' else precision}"
      require(ref[jax_key]["complete"] and len(ref[jax_key]["per_video"])
              == len(per_video) == synthetic.HELD_OUT_SETS[set_name][
                  "num_examples"],
              f"eval-synth {jax_key}: {len(per_video)} videos scored, JAX's "
              f"record holds {ref[jax_key]['videos']}")
      mean = {k: float(np.mean([m[k] for m in per_video]))
              for k in per_video[0]}
      jax_mean = ref[jax_key]["mean"]
      gaps = {k: mean[k] - jax_mean[k] for k in jax_mean}
      require(all(np.isfinite(v) for v in mean.values()) and len(mean) == 13,
              f"eval-synth {set_name}:{precision}: {mean}")
      if precision == "fp32":
        guard = EVAL_FP32_TOL
        ok = all(abs(g) <= guard for g in gaps.values())
      else:
        spread = "bf16" if precision == "tf32" else precision
        guard = max(EVAL_GUARD_FLOOR, 2 * abs(
            ref[f"{set_name}:{spread}"]["mean"]["average_jaccard"]
            - ref[f"{set_name}:fp32"]["mean"]["average_jaccard"]))
        ok = abs(gaps["average_jaccard"]) <= guard
      video_aj = [m["average_jaccard"] for m in per_video]
      jax_video_aj = [m["average_jaccard"] for m in ref[jax_key]["per_video"]]
      r = result[f"{set_name}:{precision}"] = dict(
          metrics=mean, jax_metrics=jax_mean, gaps=gaps,
          max_abs_gap=max(abs(g) for g in gaps.values()),
          guard=guard, held="every metric" if precision == "fp32" else "AJ",
          within=ok, per_video_aj=video_aj,
          per_video_aj_max_gap=float(np.max(np.abs(
              np.subtract(video_aj, jax_video_aj)))),
          launches=counts, seconds=seconds, videos=len(per_video),
          tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                    cudnn=torch.backends.cudnn.allow_tf32))
      print(f"eval-synth {set_name}:{precision}: AJ {mean['average_jaccard']:.6f} "
            f"(JAX {jax_mean['average_jaccard']:.6f}, gap "
            f"{gaps['average_jaccard']:+.2e}, guard {guard:.4g}) "
            f"{seconds:.1f} s", flush=True)
      require(ok, f"eval-synth {set_name}:{precision} outside its guard: {r}")
      del predictor
  finally:
    torch.backends.cudnn.allow_tf32 = True
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
  return result


# ------------------------------------------------------------------ TAPNext

# Kernel-name fragments per layer of the TAPNext profile, matched in order.
# The SSM block's products are float32 (TF32 off): cuBLAS's SIMT kernels,
# named "f32f32" or "sgemm" (and "gemvx" for the heads of a one-frame step).
# The ViT blocks' bf16 products run on the tensor cores (cuBLASLt's "nvjet"
# kernels, or "gemm" ones of other names).
TAPNEXT_LAYERS = (
    ("K5 linear_scan", ("linear_scan_kernel",)),
    ("attention (scaled_dot_product_attention)",
     ("flash", "fmha", "sdpa", "attention")),
    ("matmuls, fp32 (SSM block, heads)", ("f32f32", "sgemm", "gemvx")),
    ("matmuls, bf16 (ViT blocks)", ("nvjet", "gemm", "cutlass", "xmma")),
)


def tapnext_flops(cfg, frames, queries):
  """Multiply-add operations (x2) of one TAPNext pass by operand type: the
  SSM block's float32 products (linear_x, linear_y, linear_out, ffw_up,
  ffw_down, the block-diagonal gates), the ViT blocks' products in the
  compute dtype (q/k/v/out, MLP) and attention's two products."""
  d, m, heads = cfg.width, cfg.mlp_dim, cfg.num_heads
  tokens = (cfg.image_size[0] // cfg.patch_size[1]) * (
      cfg.image_size[1] // cfg.patch_size[2]) + queries
  per_token_ssm = 3 * d * d + 2 * d * m + d * m + 2 * d * (d // heads)
  per_token_vit = 4 * d * d + 2 * d * m
  per_token_attn = 2 * tokens * d
  scale = 2.0 * frames * tokens * cfg.depth
  return dict(fp32_ssm=scale * per_token_ssm, compute_dtype_vit=scale * per_token_vit,
              attention=scale * per_token_attn)


def tapnext_golden_check(params):
  """ViT-B on the golden clip against the JAX golden outputs: the model's
  pass (tracks, coordinate and visibility logits) and TapnextPredictor with
  the golden's chunk size, in fp32 (TF32 off) and bf16; then the fp32
  predictor in one pass against its time-chunked run."""
  golden = np.load(TAPNEXT_GOLDEN)
  video, qp = golden_clip()
  torch.backends.cuda.matmul.allow_tf32 = False
  result, failed = {}, []
  for name in ("float32", "bfloat16"):
    predictor = TapnextPredictor(params, SsmVitConfig(compute_dtype=name),
                                 chunk_size=TAPNEXT_GOLDEN_CHUNK)
    reset_counts()
    with torch.inference_mode():
      out = predictor.model(torch.from_numpy(video).cuda(),
                            torch.from_numpy(qp).cuda(), intermediates=False)
    call_launches = read_counts()["linear_scan"]
    reset_counts()
    pred = predictor(video, qp)
    pred_launches = read_counts()["linear_scan"]
    tracks = out.tracks.cpu().numpy()
    ref = {k: golden[f"{name}_call_{k}"]
           for k in ("tracks", "track_logits", "visible_logits")}
    r = result[name] = dict(
        k5_launches=dict(call=call_launches, predictor=pred_launches),
        call_logit_max_abs=max(
            float(np.abs(getattr(out, k).cpu().numpy() - ref[k]).max())
            for k in ("track_logits", "visible_logits")),
        pred_occlusion_max_abs=float(np.abs(
            pred["occlusion"] - golden[f"{name}_pred_occlusion"]).max()))
    require(call_launches == SsmVitConfig().depth
            and pred_launches == 2 * SsmVitConfig().depth,
            f"TAPNext golden {name}: K5 launches {r['k5_launches']}")
    for key, got, want, vis_got, vis_want in (
        ("call", tracks, ref["tracks"], out.visible_logits.cpu().numpy()[..., 0] > 0,
         ref["visible_logits"][..., 0] > 0),
        ("pred", pred["tracks"], golden[f"{name}_pred_tracks"],
         pred["occlusion"] < 0, golden[f"{name}_pred_occlusion"] < 0)):
      axis_err = np.abs(got - want).max(-1)
      dist = np.linalg.norm(got - want, axis=-1)
      r[key] = dict(
          track_max_px=float(axis_err.max()),
          track_median_px=float(np.median(dist)),
          track_p95_px=float(np.percentile(dist, 95)),
          share_within_px=float(np.mean(axis_err <= TN_GOLDEN_FP32_TOL["track_px"])),
          flips_over_px=int(np.sum(axis_err > TN_GOLDEN_FP32_TOL["track_px"])),
          visible_agree=float(np.mean(vis_got == vis_want)))
      if name == "float32":
        tol = TN_GOLDEN_FP32_TOL
        ok = r[key]["share_within_px"] >= tol["share"]
      else:
        tol = GOLDEN_BF16_TOL
        ok = (r[key]["track_median_px"] <= tol["median_px"]
              and r[key]["track_p95_px"] <= tol["p95_px"]
              and r[key]["visible_agree"] >= tol["visible_agree"])
      if not ok:
        failed.append(f"{name} {key}: {r[key]} vs {tol}")
    if name == "float32":
      logits_ok = (r["call_logit_max_abs"] <= TN_GOLDEN_FP32_TOL["logits"]
                   and r["pred_occlusion_max_abs"] <= TN_GOLDEN_FP32_TOL["logits"])
      if not logits_ok:
        failed.append(f"{name} logits: {r}")
      # One pass against the time-chunked run, in the port.
      predictor.chunk_size = None
      whole = predictor(video, qp)
      occ_range = float(np.ptp(whole["occlusion"]))
      r["chunked_vs_one_pass"] = dict(
          track_max_px=float(np.abs(pred["tracks"] - whole["tracks"]).max()),
          occlusion_max_abs=float(np.abs(pred["occlusion"] - whole["occlusion"]).max()),
          occlusion_range=occ_range, tol=TN_CHUNKED_TOL)
      c = r["chunked_vs_one_pass"]
      if not (c["track_max_px"] <= TN_CHUNKED_TOL["track_px"]
              and c["occlusion_max_abs"] <= TN_CHUNKED_TOL["logit_of_range"] * occ_range):
        failed.append(f"chunked vs one pass: {c}")
    del predictor, out
    torch.cuda.empty_cache()
  require(not failed, "TAPNext golden check failed: " + "; ".join(failed))
  return result


def tapnext_videos(count, frames=None, queries=None, query_t=None):
  """256x256 clips on the device (TN_FRAMES frames unless `frames`): the
  golden clip's frames scrolled a few pixels per frame, one direction per
  video, in [-1, 1], with `queries` (TN_QUERIES) query points each, at frame
  `query_t` or spread over the clip."""
  frames = frames or TN_FRAMES
  queries = queries or TN_QUERIES
  golden = np.load(GOLDEN)
  base = torch.from_numpy(golden["video"][0]).cuda().float()  # [8, 256, 256, 3]
  gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
  videos = []
  for _ in range(count):
    vy, vx = (torch.randint(-3, 4, (2,), generator=gen)).tolist()
    clip = torch.stack([
        torch.roll(base[t % base.shape[0]], (vy * t, vx * t), dims=(0, 1))
        for t in range(frames)
    ])
    video = (clip / 255.0 * 2.0 - 1.0)[None]
    t = (torch.zeros(queries) if query_t is not None else
         torch.randint(0, frames, (queries,), generator=gen).float())
    qp = torch.stack([
        t, torch.rand(queries, generator=gen) * (TN_RES - 16) + 8,
        torch.rand(queries, generator=gen) * (TN_RES - 16) + 8,
    ], -1)[None]
    videos.append((video, qp.numpy()))
  return videos


def serve_tapnext(params):
  """serve-tapnext-256: ViT-B in bf16 compute dtype through TapnextPredictor
  with chunks of TN_CHUNK frames, one warm-up video and two timed ones. Each
  video must launch K5 depth x chunks times and no other kernel."""
  cfg = SsmVitConfig(compute_dtype="bfloat16")
  predictor = TapnextPredictor(params, cfg, chunk_size=TN_CHUNK)
  videos = tapnext_videos(3)
  predictor(*videos[0])
  torch.cuda.synchronize()
  count = len(videos) - 1
  reset_counts()
  event_ms, outs = [], []
  start = time.perf_counter()
  for video, qp in videos[1:]:
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    begin.record()
    outs.append(predictor(video, qp))
    end.record()
    torch.cuda.synchronize()
    event_ms.append(begin.elapsed_time(end))
  wall = time.perf_counter() - start
  launches = read_counts()
  expected = cfg.depth * (-(-TN_FRAMES // TN_CHUNK))
  require(launches["linear_scan"] == expected * count
          and sum(launches.values()) == launches["linear_scan"],
          f"serve-tapnext: launches {launches}, expected {expected} K5 per "
          "video and no other kernel")
  for out in outs:
    require(out["tracks"].shape == (1, TN_QUERIES, TN_FRAMES, 2),
            f"tracks shape {out['tracks'].shape}")
    for key in ("tracks", "occlusion"):
      require(np.isfinite(out[key]).all(), f"serve-tapnext: non-finite {key}")
    require(np.abs(out["tracks"]).max() < 4 * TN_RES, "tracks far off the frame")
  flops = tapnext_flops(cfg, TN_FRAMES, TN_QUERIES)
  return dict(
      config=dict(variant="ViT-B", compute_dtype="bfloat16",
                  weights=f"tools/tapnext_weights.py seed {TAPNEXT_SEED}"),
      videos=count, frames=TN_FRAMES, queries=TN_QUERIES, chunk=TN_CHUNK,
      resolution=TN_RES, wall_s_total=wall, wall_s_per_video=wall / count,
      event_ms_per_video=event_ms,
      launches_per_video={k: v // count for k, v in launches.items()},
      visible_frac=[float(np.mean(o["occlusion"] < 0)) for o in outs],
      fp32_matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
      float32_matmul_precision=torch.get_float32_matmul_precision(),
      flops_per_video=flops,
      profile=profile_request(lambda: predictor(*videos[1]), wall / count,
                              layers=TAPNEXT_LAYERS, own=("linear_scan",),
                              top=25))


def online_tapnext(params):
  """online-tapnext-256: ViT-B bf16, 64 queries on the first frame, init on
  one frame, then TN_ONLINE_STEPS one-frame predict steps (each returns its
  tracks to the host). T = 1 everywhere, so K5 never launches."""
  cfg = SsmVitConfig(compute_dtype="bfloat16")
  online = OnlineTapnextPredictor(params, cfg)
  (video, qp), = tapnext_videos(1, frames=TN_ONLINE_STEPS + 1,
                                queries=TN_ONLINE_QUERIES, query_t=0)
  online.init(video[:, :1], qp)  # warm-up
  for t in range(1, 6):
    online.predict(video[:, t])
  torch.cuda.synchronize()
  reset_counts()
  online.init(video[:, :1], qp)
  step_ms, tracks = [], []
  for t in range(1, TN_ONLINE_STEPS + 1):
    begin = time.perf_counter()
    tr, _ = online.predict(video[:, t])
    step_ms.append((time.perf_counter() - begin) * 1e3)
    tracks.append(tr)
  launches = read_counts()
  require(sum(launches.values()) == 0,
          f"online-tapnext launched kernels of the port: {launches}")
  tracks = np.stack(tracks)
  require(tracks.shape == (TN_ONLINE_STEPS, 1, TN_ONLINE_QUERIES, 2)
          and np.isfinite(tracks).all(), "online-tapnext: bad tracks")
  mean_ms = float(np.mean(step_ms))
  profile = profile_request(lambda: [online.predict(video[:, t])
                                     for t in range(1, 11)],
                            mean_ms * 10 / 1e3, layers=TAPNEXT_LAYERS,
                            own=("linear_scan",), top=25)
  return dict(
      config=dict(variant="ViT-B", compute_dtype="bfloat16",
                  weights=f"tools/tapnext_weights.py seed {TAPNEXT_SEED}"),
      queries=TN_ONLINE_QUERIES, resolution=TN_RES, steps=TN_ONLINE_STEPS,
      ms_per_frame_mean=mean_ms, ms_per_frame_median=float(np.median(step_ms)),
      ms_per_frame_min=float(np.min(step_ms)),
      launches=launches,
      note="one frame per step (T = 1): the RG-LRU takes the one-step "
           "formula and launches no K5",
      profile_10_steps=profile)


# ----------------------------------------------------------------- training

# Kernel-name fragments per layer of the training profile, matched in order.
# fp32 attention runs PyTorch's memory-efficient kernels (fmha_cutlassF
# forward, fmha_cutlassB backward).
TRAIN_LAYERS = (
    ("K5b linear_scan_backward", ("linear_scan_backward_kernel",)),
    ("K5 linear_scan", ("linear_scan_kernel",)),
    ("attention backward", ("cutlassb", "fmha_bwd", "flash_bwd", "backward")),
    ("attention forward", ("cutlassf", "fmha", "flash", "attention")),
    ("matmuls, fp32", ("f32f32", "sgemm", "gemvx", "gemm", "nvjet", "cutlass",
                       "xmma")),
)


def train_golden_check(device="cuda"):
  """The port's Trainer on tools/make_tapnext_train_golden.py's weights and
  batch (fp32, TF32 off), both losses, 3 steps each, held to the JAX numbers
  of tests/data/tapnext_train_golden.npz within the limits that tool states.
  The steps launch K5 and K5b (T = 4 and chunks of 2) and no other kernel."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  golden = train_golden.load()
  reset_counts()
  port = train_golden.run_port(device, counters=read_counts)
  record, failures = train_golden.judge(golden, port)
  for name in train_golden.BUILDERS:
    launches = port[name]["launches"]
    record[name]["launches_per_3_steps"] = launches
    require(launches["linear_scan"] > 0 and launches["linear_scan_backward"] > 0
            and sum(launches.values()) == launches["linear_scan"]
            + launches["linear_scan_backward"],
            f"train-golden {name}: launches {launches}")
  require(not failures, "train-golden: " + "; ".join(failures[:10]))
  return record


def _finite_scalars(scalars, what):
  out = {k: float(v) for k, v in scalars.items()}
  require(all(np.isfinite(v) for v in out.values()), f"{what}: {out}")
  return out


def _timed_step(trainer, state, batch, what):
  """One training step timed by CUDA events and the host clock, with its
  peak memory and the kernels it launched."""
  reset_counts()
  torch.cuda.reset_peak_memory_stats()
  begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start = time.perf_counter()
  begin.record()
  state, scalars = trainer.step_fn(state, batch,
                                   trainer.step_generator(state.step))
  end.record()
  torch.cuda.synchronize()
  wall = time.perf_counter() - start
  launches = read_counts()
  return state, dict(
      step=state.step - 1, ms=begin.elapsed_time(end), wall_ms=wall * 1e3,
      max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
      learning_rate=trainer.lr_schedule(state.step - 1), launches=launches,
      scalars=_finite_scalars(scalars, what))


def train_tapnext_256(device="cuda", batch=TRAIN_BATCH, frames=TRAIN_FRAMES,
                      queries=TRAIN_QUERIES, steps=TRAIN_STEPS, variant="B"):
  """train-tapnext-256: tapnext_experiment() (ViT-B, fp32) with remat, its
  full-T loss with deep supervision, synthetic batches made on the card; a
  warm-up step (step 0, learning rate 0: the parameters must not move) and
  `steps` timed steps (the first must move them). Each step launches K5
  2 x depth times (forward and remat's recompute), K5b depth times and no
  other kernel."""
  exp = train_configs.tapnext_experiment(variant)
  exp = dataclasses.replace(
      exp, model_config=dataclasses.replace(exp.model_config, remat=True))
  cfg = exp.model_config
  t = trainer_lib.Trainer(exp.build_model(), exp.optimizer, exp.total_steps,
                          task=exp.task, loss_builder=exp.loss_builder,
                          device=device)
  state = t.init_state()
  data = synthetic.batch_iterator(
      seed=SEED, device=device, batch_size=batch, num_frames=frames,
      height=cfg.image_size[0], width=cfg.image_size[1], num_queries=queries)
  batches = [next(data) for _ in range(steps + 2)]
  before = {k: p.detach().clone() for k, p in state.params.items()}
  state, warm = _timed_step(t, state, batches[0], "train-tapnext warm-up")
  require(all(torch.equal(before[k], p) for k, p in state.params.items()),
          "train-tapnext: step 0 (learning rate 0) moved the parameters")
  records = []
  for i, b in enumerate(batches[1:steps + 1]):
    state, rec = _timed_step(t, state, b, "train-tapnext")
    launches = rec["launches"]
    require(launches["linear_scan"] == 2 * cfg.depth
            and launches["linear_scan_backward"] == cfg.depth
            and sum(launches.values()) == 3 * cfg.depth,
            f"train-tapnext: launches {launches}, expected {2 * cfg.depth} "
            f"K5 and {cfg.depth} K5b")
    if i == 0:
      moved = sum(not torch.equal(before[k], p) for k, p in state.params.items())
      require(moved == len(before),
              f"train-tapnext: step 1 moved {moved} of {len(before)} parameters")
    records.append(rec)
  del before
  require(all(bool(torch.isfinite(p).all()) for p in state.params.values()),
          "train-tapnext: non-finite parameters")
  mean_ms = float(np.mean([r["ms"] for r in records]))
  profile = profile_request(lambda: t.step_fn(state, batches[-1]),
                            float(np.mean([r["wall_ms"] for r in records])) / 1e3,
                            layers=TRAIN_LAYERS, own=("linear_scan",), top=25)
  # The products of a step: the forward's, again in remat's recompute, and
  # twice in the backward (the input's and the weights' gradients).
  flops = {k: 4 * batch * v for k, v in tapnext_flops(cfg, frames, queries).items()}
  products = flops["fp32_ssm"] + flops["compute_dtype_vit"]
  return dict(
      config=dict(experiment="tapnext_experiment()", variant=variant,
                  compute_dtype=cfg.compute_dtype, remat=cfg.remat,
                  weights="init_tapnext_params seed 42",
                  data=f"data/synthetic.py on the card, seed {SEED}"),
      batch=batch, frames=frames, queries=queries, resolution=cfg.image_size[0],
      scan_shape=list(TRAIN_SCAN_SHAPE) if frames == TRAIN_FRAMES else None,
      warm_up=warm, steps=records, ms_per_step_mean=mean_ms,
      max_memory_gb=max(r["max_memory_gb"] for r in records),
      launches_per_step=records[-1]["launches"],
      fp32_matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
      flops_per_step=flops,
      products_tflop_per_s=(products / (profile["by_layer_ms"]["matmuls, fp32"] * 1e9)
                            if profile["by_layer_ms"]["matmuls, fp32"] else None),
      profile=profile)


def train_tapnextpp(device="cuda", frames=TRAINPP_FRAMES,
                    queries=TRAINPP_QUERIES, steps=TRAINPP_STEPS, variant="B"):
  """train-tapnextpp: tapnextpp_experiment() (ViT-B, remat, batch 1, chunks
  of 128) on `frames`-frame clips (cut from 1024): a warm-up step and `steps`
  timed ones. Then the carried state's gradient: with every query on the
  first chunk, the second chunk holds only [M] tokens, so the gradient of
  the second chunk's loss reaches the query token and the full-resolution
  position embedding only through the state carried from the first chunk:
  it must be non-zero, and exactly zero with that state detached."""
  exp = train_configs.tapnextpp_experiment(variant)
  cfg, chunk = exp.model_config, exp.train_time_chunk
  t = trainer_lib.Trainer(exp.build_model(), exp.optimizer, exp.total_steps,
                          task=exp.task, loss_builder=exp.loss_builder,
                          device=device)
  state = t.init_state()
  data = synthetic.batch_iterator(
      seed=SEED, device=device, batch_size=exp.data.batch_size,
      num_frames=frames, height=cfg.image_size[0], width=cfg.image_size[1],
      num_queries=queries)
  batches = [next(data) for _ in range(steps + 1)]
  state, warm = _timed_step(t, state, batches[0], "train-tapnextpp warm-up")
  records = []
  for b in batches[1:]:
    state, rec = _timed_step(t, state, b, "train-tapnextpp")
    require(rec["launches"]["linear_scan_backward"] == cfg.depth * (frames // chunk),
            f"train-tapnextpp: launches {rec['launches']}")
    records.append(rec)

  model = t.model
  b = batches[-1]
  qp = torch.cat([torch.zeros_like(b["query_points"][..., :1]),
                  b["target_points"][:, :, 0].flip(-1)], -1)
  video = b["video"]
  leaves = (model.backbone.point_query_token, model.backbone.pos_embedding_full)
  reset_counts()
  first = model.forward_step(video[:, :chunk], qp)

  def second_chunk_loss(state):
    r = model.forward_step(video[:, chunk:2 * chunk], state=state)
    target = b["target_points"][:, :, chunk:2 * chunk].flip(-1)
    visible = 1.0 - b["occluded"][:, :, chunk:2 * chunk]
    return tapnext_losses.tapnext_loss(r, target, visible)[0]

  grads = torch.autograd.grad(second_chunk_loss(first.state), leaves)
  carried_launches = read_counts()
  cut = dataclasses.replace(first.state, hidden_state=type(first.state.hidden_state)(
      *(h.detach() for h in first.state.hidden_state)))
  cut_grads = torch.autograd.grad(second_chunk_loss(cut), leaves,
                                  allow_unused=True)
  norms = [float(g.norm()) for g in grads]
  cut_norms = [0.0 if g is None else float(g.norm()) for g in cut_grads]
  require(all(n > 0 and np.isfinite(n) for n in norms),
          f"train-tapnextpp: no gradient through the carried state: {norms}")
  require(all(n == 0.0 for n in cut_norms),
          f"train-tapnextpp: gradient without the carried state: {cut_norms}")
  return dict(
      config=dict(experiment="tapnextpp_experiment()", variant=variant,
                  remat=cfg.remat, chunk=chunk,
                  weights="init_tapnext_params seed 42"),
      batch=exp.data.batch_size, frames=frames, frames_preset=exp.data.num_frames,
      queries=queries, warm_up=warm, steps=records,
      ms_per_step_mean=float(np.mean([r["ms"] for r in records])),
      max_memory_gb=max(r["max_memory_gb"] for r in records),
      launches_per_step=records[-1]["launches"],
      carried_state_gradient=dict(
          leaves=["backbone.point_query_token", "backbone.pos_embedding_full"],
          norms=norms, norms_with_state_detached=cut_norms,
          launches=carried_launches))


# ------------------------------------------------------------ TAPIR training


def _pytorch_tf32_defaults():
  """PyTorch's TF32 settings at their defaults (cuDNN on, matmul off), as
  the training CLI runs."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = True


def train_golden_tapir(runs=("identity", "permuted")):
  """train-golden-tapir (and, with runs=("bootstrap",), bootstrap-golden):
  the port on tools/make_tapir_train_golden.py's small BootsTAPIR, weights
  and batches (fp32, TF32 off), held to the JAX numbers of
  tests/data/tapir_train_golden.npz within that tool's card limits (its CPU
  limits printed beside them). Every step launches K1 and K3."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    golden = tapir_golden.load()
    reset_counts()
    port = tapir_golden.run_port("cuda", golden, counters=read_counts,
                                 runs=runs)
    record, failures = tapir_golden.judge(golden, port, runs=runs, card=True)
    cpu_record, _ = tapir_golden.judge(golden, port, runs=runs)
  finally:
    _pytorch_tf32_defaults()
  for run in runs:
    launches = port[run]["launches_per_step"]
    record[run].update(launches_per_step=launches,
                       over_the_cpu_limits=cpu_record[run])
    require(launches["corr_tents"] > 0 and launches["mixer_block"] > 0,
            f"train-golden-tapir {run}: launches {launches}")
  require(not failures, "train-golden-tapir: " + "; ".join(failures[:10]))
  return record


def _tapir_launches(cfg, chunks, resolutions=1):
  """K1 and K3 launches of one TAPIR training step: per chunk, per
  refinement iteration, one K1 per pyramid grid and one K3 per block (the
  backward launches none: it recomputes the plain math)."""
  iters = cfg.num_pips_iter * resolutions * chunks
  return dict(corr_tents=iters * (2 + cfg.pyramid_level),
              mixer_block=iters * cfg.num_mixer_blocks)


def train_bootstapir_256(batch=TRAIN_TAPIR_BATCH, frames=TRAIN_TAPIR_FRAMES,
                         queries=TRAIN_TAPIR_QUERIES, steps=TRAIN_TAPIR_STEPS):
  """train-bootstapir-256: bootstapir_experiment() at its own data size
  (batch 8 x 24 frames x 256x256, 256 queries in chunks of 32, float32),
  fresh parameters (init_tapir_params seed 42), synthetic batches made on
  the card, PyTorch's TF32 defaults; a warm-up step (step 0, learning rate
  0: the parameters must not move) and `steps` timed steps, each launching
  K1 and K3 as `_tapir_launches` counts and no other kernel; then one
  profiled step by layer."""
  _pytorch_tf32_defaults()
  exp = train_configs.bootstapir_experiment()
  cfg = exp.model_config
  t = trainer_lib.Trainer(exp.build_model(), exp.optimizer, exp.total_steps,
                          task=exp.task, loss_builder=exp.loss_builder,
                          device="cuda")
  state = t.init_state()
  data = synthetic.batch_iterator(
      seed=SEED, device="cuda", batch_size=batch, num_frames=frames,
      height=cfg.initial_resolution[0], width=cfg.initial_resolution[1],
      num_queries=queries)
  batches = [next(data) for _ in range(steps + 1)]
  before = {k: p.detach().clone() for k, p in state.params.items()}
  state, warm = _timed_step(t, state, batches[0], "train-bootstapir warm-up")
  require(all(torch.equal(before[k], p) for k, p in state.params.items()),
          "train-bootstapir: step 0 (learning rate 0) moved the parameters")
  expected = _tapir_launches(cfg, -(-queries // exp.task.train_chunk_size))
  records = []
  for i, b in enumerate(batches[1:]):
    state, rec = _timed_step(t, state, b, "train-bootstapir")
    launches = {k: v for k, v in rec["launches"].items() if v}
    require(launches == expected,
            f"train-bootstapir: launches {launches}, expected {expected}")
    if i == 0:
      rec["parameters_moved"] = sum(
          not torch.equal(before[k], p) for k, p in state.params.items())
    records.append(rec)
  del before
  require(all(bool(torch.isfinite(p).all()) for p in state.params.values()),
          "train-bootstapir: non-finite parameters")
  profile = profile_request(
      lambda: t.step_fn(state, batches[-1], t.step_generator(state.step)),
      float(np.mean([r["wall_ms"] for r in records])) / 1e3, top=15)
  return dict(
      config=dict(experiment="bootstapir_experiment()",
                  compute_dtype=cfg.compute_dtype,
                  weights="init_tapir_params seed 42",
                  data=f"data/synthetic.py on the card, seed {SEED}",
                  tf32="PyTorch defaults: cuDNN on, matmul off"),
      batch=TRAIN_TAPNET_BATCH, frames=TRAIN_TAPNET_FRAMES,
      queries=TRAIN_TAPNET_QUERIES, chunk=exp.task.train_chunk_size,
      resolution=cfg.initial_resolution[0], warm_up=warm, steps=records,
      parameters=len(state.params),
      ms_per_step_mean=float(np.mean([r["ms"] for r in records])),
      max_memory_gb=max(r["max_memory_gb"] for r in records),
      launches_per_step=records[-1]["launches"], profile=profile)


def train_bootstapir_synth(steps=SYNTH_STEPS):
  """train-bootstapir-synth: the JAX package's recipe (README.md, Training:
  `--experiment bootstapir --synthetic --num_frames 16 --batch_size 4
  --num_queries 128 --total_steps 6000`) for its first `steps` steps from
  init_tapir_params (seed 42), through Trainer's step and query-order
  generators as the CLI runs them, at PyTorch's TF32 defaults. Gate: the
  mean loss of the last 50 steps is at most SYNTH_GATE of the first 50's."""
  _pytorch_tf32_defaults()
  exp = train_configs.bootstapir_experiment()
  cfg = exp.model_config
  t = trainer_lib.Trainer(exp.build_model(), exp.optimizer, SYNTH_HORIZON,
                          task=exp.task, loss_builder=exp.loss_builder,
                          device="cuda")
  state = t.init_state()
  data = synthetic.batch_iterator(
      seed=SEED, device="cuda", batch_size=SYNTH_BATCH,
      num_frames=SYNTH_FRAMES, height=cfg.initial_resolution[0],
      width=cfg.initial_resolution[1], num_queries=SYNTH_QUERIES)
  torch.cuda.reset_peak_memory_stats()
  losses, positions = [], []
  begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start = time.perf_counter()
  begin.record()
  for _ in range(steps):
    state, scalars = t.step_fn(state, next(data), t.step_generator(state.step))
    losses.append(scalars["loss"])
    positions.append(scalars["position_loss"])
  end.record()
  torch.cuda.synchronize()
  wall = time.perf_counter() - start
  losses = torch.stack(losses).cpu().numpy().astype(np.float64)
  positions = torch.stack(positions).cpu().numpy().astype(np.float64)
  window = 50
  first, last = float(losses[:window].mean()), float(losses[-window:].mean())
  require(bool(np.isfinite(losses).all()), "train-bootstapir-synth: non-finite loss")
  require(last <= SYNTH_GATE * first,
          f"train-bootstapir-synth: mean loss of the last {window} steps "
          f"{last} over {SYNTH_GATE} of the first {window}'s {first}")
  means = lambda v: [float(v[i:i + window].mean()) for i in range(0, steps, window)]
  return dict(
      config=dict(experiment="bootstapir_experiment()",
                  total_steps=SYNTH_HORIZON, weights="init_tapir_params seed 42",
                  data=f"data/synthetic.py on the card, seed {SEED}",
                  tf32="PyTorch defaults: cuDNN on, matmul off"),
      batch=SYNTH_BATCH, frames=SYNTH_FRAMES, queries=SYNTH_QUERIES,
      steps=steps, ms_per_step=begin.elapsed_time(end) / steps,
      wall_s=wall, max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
      loss_first_50=first, loss_last_50=last, ratio=last / first,
      gate=SYNTH_GATE, loss_means_per_50=means(losses),
      position_loss_means_per_50=means(positions),
      loss_at_50_steps=[float(losses[i]) for i in range(window - 1, steps, window)])


def train_bootstrap_256(params, steps=BOOTSTRAP_STEPS):
  """train-bootstrap-256: one BootsTAP step at full width, as
  scratch/bootstap_demo.py sets it up: the trained checkpoint as the student
  and the teacher, 4 unlabeled videos of 16 frames at 256x256 (12 sprites,
  7 px a frame) with 128 queries in chunks of 32, and a labeled anchor of 4
  such videos with 64 queries (6 sprites); lr 2e-5, warmup 100, EMA 0.999,
  gate -1. A warm-up step (learning rate 0: the student must not move) and
  `steps` timed steps; each step launches K1 and K3 for the teacher, the
  student and the anchor."""
  _pytorch_tf32_defaults()
  cfg = bootstapir_config()
  student = tapir_lib.TAPIR(cfg).cuda()
  teacher = tapir_lib.TAPIR(cfg).cuda()
  opt = optimizers_lib.OptimizerConfig(base_lr=2e-5, warmup_steps=100,
                                       weight_decay=0.0, adam_b2=0.95)
  tx = optimizers_lib.make_optimizer(opt,
                                     optimizers_lib.make_lr_schedule(opt, 1000))
  state = bootstrap_lib.init_bootstrap_state(student, teacher, params, tx)
  config = bootstrap_lib.BootstrapConfig(num_queries=128, query_chunk_size=32,
                                         ema_decay=0.999, confidence_gate=-1.0)
  step_fn = bootstrap_lib.make_bootstrap_train_step(student, teacher, tx,
                                                    config)
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  batches = []
  for _ in range(steps + 1):
    video = synthetic.make_batch(gen, 4, 16, 256, 256, 8, num_sprites=12,
                                 vel_range=7.0)["video"]
    batches.append({"video": video,
                    "labeled": synthetic.make_batch(gen, 4, 16, 256, 256, 64)})
  before = {k: p.detach().clone() for k, p in state.params.items()}
  records = []
  for i, batch in enumerate(batches):
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    begin.record()
    state, scalars = step_fn(state, batch,
                             bootstrap_lib.step_generator(state.step))
    end.record()
    torch.cuda.synchronize()
    if i == 0:
      require(all(torch.equal(before[k], p) for k, p in state.params.items()),
              "train-bootstrap: step 0 (learning rate 0) moved the student")
    launches = {k: v for k, v in read_counts().items() if v}
    require(launches.get("corr_tents", 0) > 0 and launches.get("mixer_block", 0) > 0
            and set(launches) == {"corr_tents", "mixer_block"},
            f"train-bootstrap: launches {launches}")
    records.append(dict(
        step=state.step - 1, ms=begin.elapsed_time(end),
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches,
        scalars=_finite_scalars(scalars, "train-bootstrap")))
  del before
  return dict(
      config=dict(weights=os.path.relpath(CHECKPOINT, REPO),
                  bootstrap="num_queries 128, chunk 32, ema 0.999, gate -1",
                  optimizer="lr 2e-5, warmup 100, weight decay 0, b2 0.95",
                  tf32="PyTorch defaults: cuDNN on, matmul off"),
      unlabeled="4 x 16 x 256x256, 12 sprites, 7 px a frame",
      labeled="4 x 16 x 256x256, 64 queries", warm_up=records[0],
      steps=records[1:], ms_per_step_mean=float(np.mean([r["ms"] for r in records[1:]])),
      max_memory_gb=max(r["max_memory_gb"] for r in records))


# train-tapnet-256: tapnet_experiment()'s own data size.
TRAIN_TAPNET_BATCH, TRAIN_TAPNET_FRAMES, TRAIN_TAPNET_QUERIES = 8, 24, 256
TRAIN_TAPNET_STEPS = 2
TAPNET_LAYERS = (
    ("convolutions (cuDNN: forward, dgrad, wgrad)",
     ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "cudnn")),
    ("matmuls (cost volume, contrastive dots, dense)",
     ("gemm", "nvjet", "cutlass", "gemv", "xmma")),
    ("reductions (BatchNorm statistics, softmax, means)",
     ("reduce", "softmax", "welford", "norm")),
)
# serve-trajan-150: TrackAutoEncoder() at its published widths.
SERVE_TRAJAN_CLIPS, SERVE_TRAJAN_TRACKS, SERVE_TRAJAN_FRAMES = 4, 256, 150
SERVE_TRAJAN_CHUNK, SERVE_TRAJAN_PASSES = 256, 3
TRAJAN_LAYERS = (
    ("matmuls (projections, attention, MLPs)",
     ("gemm", "nvjet", "cutlass", "gemv", "xmma")),
    ("softmax", ("softmax",)),
    ("norms (LayerNorm, RMSNorm statistics)", ("reduce", "norm", "welford")),
)


def tapnet_golden_check():
  """tapnet-golden: full-width TAP-Net (TapNetConfig(): TSM-ResNet-18,
  stride 8, unit_2) with tools/tapnet_weights.py's seed-made weights on the
  golden clip (8 x 256x256, 32 queries in chunks of 16), float32 with TF32
  off: the eval and training forwards, and one value_and_grad of the TAP
  loss and of the contrastive loss (loss, scalars, the running statistics
  after the step, the gradient fingerprints), against
  tests/data/tapnet_golden.npz within tools/make_tapnet_golden.py's card
  limits. Also reports (holds nothing by it) the same readings against the
  nudge witness alone, the CPU test's limits."""
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  golden = np.load(tapnet_golden.OUT)
  port = tapnet_golden.run_port("cuda")
  r = tapnet_golden.judge(golden, port, card=True)
  torch.backends.cudnn.allow_tf32 = True
  require(r["ok"], f"tapnet-golden: {r}")
  r["nudge_witness_only"] = tapnet_golden.judge(golden, port)
  return r


def train_tapnet_256():
  """train-tapnet-256: tapnet_experiment() at its own data size (batch 8 x
  24 frames x 256x256, 256 queries in chunks of 32, the TAP loss, float32),
  fresh parameters (init_tapnet_params seed 42), synthetic batches made on
  the card, PyTorch's TF32 defaults; a warm-up step (step 0, learning rate
  0: the parameters must not move) and TRAIN_TAPNET_STEPS timed steps;
  every leaf finite, the running statistics moved by every step's forward;
  then one profiled step by layer. TAP-Net runs no hand-written kernel:
  cuDNN's convolutions and cuBLAS's products, as the JAX package's XLA
  ones."""
  _pytorch_tf32_defaults()
  exp = train_configs.tapnet_experiment()
  t = trainer_lib.Trainer(exp.build_model(), exp.optimizer, exp.total_steps,
                          task=exp.task, loss_builder=exp.loss_builder,
                          device="cuda")
  state = t.init_state()
  size = exp.data.train_size[0]
  data = synthetic.batch_iterator(
      seed=SEED, device="cuda", batch_size=TRAIN_TAPNET_BATCH,
      num_frames=TRAIN_TAPNET_FRAMES, height=size, width=size,
      num_queries=TRAIN_TAPNET_QUERIES)
  batches = [next(data) for _ in range(TRAIN_TAPNET_STEPS + 1)]
  before = {k: p.detach().clone() for k, p in state.params.items()}
  stats = lambda: {k: v.clone() for k, v in
                   state.model_state["batch_stats"].items()}
  fresh = stats()
  state, warm = _timed_step(t, state, batches[0], "train-tapnet warm-up")
  require(all(torch.equal(before[k], p) for k, p in state.params.items()),
          "train-tapnet: step 0 (learning rate 0) moved the parameters")
  records = []
  for b in batches[1:]:
    last = stats()
    state, rec = _timed_step(t, state, b, "train-tapnet")
    require(not any(rec["launches"].values()),
            f"train-tapnet: launched {rec['launches']}")
    moved = state.model_state["batch_stats"]
    rec["running_stats_moved"] = sum(not torch.equal(last[k], v)
                                     for k, v in moved.items())
    require(rec["running_stats_moved"] == len(moved),
            f"train-tapnet: {rec['running_stats_moved']} of {len(moved)} "
            "running statistics moved")
    records.append(rec)
  moved = sum(not torch.equal(before[k], p) for k, p in state.params.items())
  require(moved > 0, "train-tapnet: the steps moved no parameter")
  require(all(bool(torch.isfinite(p).all()) for p in state.params.values())
          and all(bool(torch.isfinite(v).all())
                  for v in state.model_state["batch_stats"].values()),
          "train-tapnet: non-finite parameters or running statistics")
  drift = max(float((v - fresh[k]).abs().max())
              for k, v in state.model_state["batch_stats"].items())
  del before, fresh
  profile = profile_request(
      lambda: t.step_fn(state, batches[-1], t.step_generator(state.step)),
      float(np.mean([r["wall_ms"] for r in records])) / 1e3,
      layers=TAPNET_LAYERS, own=(), top=15)
  return dict(
      config=dict(experiment="tapnet_experiment()",
                  model="TapNetConfig(): TSM-ResNet-18, stride 8, unit_2",
                  weights="init_tapnet_params seed 42",
                  data=f"data/synthetic.py on the card, seed {SEED}",
                  tf32="PyTorch defaults: cuDNN on, matmul off"),
      batch=TRAIN_TAPNET_BATCH, frames=TRAIN_TAPNET_FRAMES,
      queries=TRAIN_TAPNET_QUERIES, chunk=exp.task.train_chunk_size, resolution=size,
      warm_up=warm, steps=records, parameters=len(state.params),
      parameters_moved=moved,
      running_stats_max_drift=drift,
      ms_per_step_mean=float(np.mean([r["ms"] for r in records])),
      max_memory_gb=max(r["max_memory_gb"] for r in records),
      profile=profile)


def trajan_golden_check():
  """trajan-golden: TrackAutoEncoder() at its published widths (150
  frames, 128 x 64 latents) with tools/trajan_weights.py's seed-made
  weights on tools/make_trajan_golden.py's clip (64 support tracks, one
  never visible, boundary_frame 120; 64 queries, 8 at frames past 153,
  where the time window clamps), JAX's dither fed, float32 with TF32 off:
  encode, decode on JAX's latents, the one-pass forward and the chunked one
  (decoder_chunk_size=16) against tests/data/trajan_golden.npz within that
  tool's limits."""
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  golden = np.load(trajan_golden.OUT)
  r = trajan_golden.judge(golden, *trajan_golden.run_port(golden, "cuda"))
  torch.backends.cudnn.allow_tf32 = True
  require(r["ok"], f"trajan-golden: {r}")
  return r


def serve_trajan_150():
  """serve-trajan-150: TrackAutoEncoder() at its published widths on
  SERVE_TRAJAN_CLIPS clips of SERVE_TRAJAN_TRACKS support tracks x
  SERVE_TRAJAN_FRAMES frames (the example's synthetic tracks, a clip per
  seed), decoding the 32 x 32 grid's 1024 queries, given explicitly, with
  decoder_chunk_size=SERVE_TRAJAN_CHUNK; float32 at PyTorch's defaults,
  under no_grad: a warm-up pass and SERVE_TRAJAN_PASSES timed ones (CUDA
  events), ms a clip, peak memory, the encoder's and the decoder's share,
  and one profiled pass by layer. Its users score motion realism by the
  reconstruction error."""
  clips, frames, chunk = SERVE_TRAJAN_CLIPS, SERVE_TRAJAN_FRAMES, SERVE_TRAJAN_CHUNK
  _pytorch_tf32_defaults()
  model = track_autoencoder.TrackAutoEncoder(decoder_chunk_size=chunk)
  convert_lib.load_trajan_params(model, seeded_trajan_params(1))
  model = model.to("cuda").eval()
  made = [synthetic_tracks(SERVE_TRAJAN_TRACKS, frames, seed=i)
          for i in range(clips)]
  centers = (np.arange(32) / 32.0 + 1.0 / 64.0).astype(np.float32)
  gx, gy = np.meshgrid(centers, centers)
  grid = np.stack([np.zeros(1024, np.float32), gx.ravel(), gy.ravel()], -1)
  inputs = {
      "support_tracks": torch.from_numpy(np.stack([m[0] for m in made])),
      "support_tracks_visible": torch.from_numpy(np.stack([m[1] for m in made])),
      "boundary_frame": torch.full((clips,), frames, dtype=torch.int32),
      "query_points": torch.from_numpy(np.broadcast_to(grid, (clips,) + grid.shape)
                                       .copy()),
  }
  inputs = {k: v.to("cuda") for k, v in inputs.items()}
  gen = torch.Generator(device="cuda").manual_seed(SEED)

  def run():
    with torch.no_grad():
      return model(inputs, generator=gen)

  run()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  times, walls = [], []
  for _ in range(SERVE_TRAJAN_PASSES):
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start = time.perf_counter()
    begin.record()
    out = run()
    end.record()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - start)
    times.append(begin.elapsed_time(end))
  require(out.tracks.shape == (clips, 1024, frames, 2)
          and all(bool(torch.isfinite(getattr(out, k)).all())
                  for k in ("tracks", "visible_logits", "certain_logits")),
          f"serve-trajan: outputs {tuple(out.tracks.shape)} not finite")
  begin, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
  with torch.no_grad():
    begin.record()
    latents = model.encode(inputs)
    mid.record()
    model.decode(latents, model.get_decoder_context(
        dict(query_points=inputs["query_points"][:, :chunk],
             boundary_frame=inputs["boundary_frame"])), generator=gen)
    end.record()
  torch.cuda.synchronize()
  profile = profile_request(run, float(np.mean(walls)), layers=TRAJAN_LAYERS,
                            own=(), top=15)
  return dict(
      config=dict(model="TrackAutoEncoder() (published widths)",
                  weights="tools/trajan_weights.py seed 1",
                  data="examples' synthetic tracks, seeds 0-3",
                  tf32="PyTorch defaults: cuDNN on, matmul off"),
      clips=clips, tracks=SERVE_TRAJAN_TRACKS, frames=frames, queries=1024,
      decoder_chunk_size=chunk, pass_ms=times,
      ms_per_clip=float(np.mean(times)) / clips,
      max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
      encode_ms=begin.elapsed_time(mid),
      decode_chunk_ms=mid.elapsed_time(end),
      decode_chunks_per_pass=1024 // chunk,
      mean_abs_track_from_grid=float(
          (out.tracks[:, :, 0] - inputs["query_points"][:, :, 1:]).abs().mean()),
      profile=profile)


# `--records PATH`: also write every record line to PATH, for a caller that
# sees only the end of the output.
# ------------------------------------------------------------- multi_rank
# The multi-device layer (tapnet_tpu_torch/parallel/) on MR_RANKS ranks that
# parallel.launch.run_ranks spawns once for the whole phase. The machine has
# one card, and NCCL refuses two ranks on one card, so the ranks share it
# over gloo, which takes CUDA tensors for its collectives: the phase checks
# the sharded algorithms, their collectives and each rank's kernel launches
# at full model width. Its times are of two ranks sharing one card over
# gloo, not a multi-GPU speed (NCCL and NVLink are not exercised). Cells:
#   serve-480-2rank: the trained BootsTAPIR at 480^2, MR_QUERIES queries in
#     chunks of CHUNK, the clip cut to MR_FRAMES frames, through
#     TapirPredictor(mesh=...) (frames over the ranks for the backbone,
#     queries for the refinement), against the one-rank predictor on the
#     same clip: fp32 with TF32 off within MR_FP32_PX on every track
#     coordinate and GOLDEN_FP32_TOL's logits; bf16 within GOLDEN_BF16_TOL.
#     K1 and K3 launch on both ranks.
#   serve-tapnext-sp-2rank: ViT-B (seed-made weights) at 256^2,
#     MR_TN_QUERIES queries, MR_TN_FRAMES frames split over the ranks in
#     time (TapnextPredictor(mesh=...)), fp32 with TF32 off, against one
#     rank within TN_GOLDEN_FP32_TOL; K5 launches exactly twice per
#     recurrent layer on each rank (the local scan and the cumulative decay)
#     and nothing else launches.
#   sp-scan-grad: sequence_parallel_linear_scan at train-tapnext-256's K5
#     shape TRAIN_SCAN_SHAPE, split over the ranks, values and gradients
#     (K5b) against one rank's linear_scan, each within MR_SCAN_REL of the
#     largest |value| of the reference (float32 sums in another order: the
#     carry enters once, as a multiply-add, instead of through the chain).
#   train-bootstapir-dp-2rank: bootstapir_experiment() at its own width, one
#     step of a global batch of MR_TRAIN_BATCH x TRAIN_TAPIR_FRAMES x 256^2
#     with MR_TRAIN_QUERIES queries, at model_parallel 1 (the clips split)
#     and 2 (the queries split), fp32 with TF32 off, the schedule's warm-up
#     dropped so that the step moves the parameters; against the one-rank
#     Trainer on the same batch and draws, with the limits of
#     tools/make_tapir_train_golden.py's header: each gradient leaf within
#     1e-4 of its largest |g| plus 1e-7 of the model's plus 3x the one-rank
#     step's own distance when the videos are nudged by 16 float32 steps,
#     and each parameter within 1e-6 of itself plus what that lets Adam's
#     first step move.
MR_RANKS = 2
MR_FRAMES, MR_QUERIES, MR_FP32_PX = 48, 256, 1e-3
MR_TN_FRAMES, MR_TN_QUERIES = 48, 64
MR_SCAN_REL = 1e-5
MR_TRAIN_BATCH, MR_TRAIN_QUERIES = 4, 128
MR_BUDGET_S = 120


def _mr_measure(fn):
  """fn() on this rank with the kernels it launched, its wall and its peak
  memory."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  reset_counts()
  start = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return out, dict(wall_s=time.perf_counter() - start,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches={k: v for k, v in read_counts().items() if v})


def _mr_tf32(on):
  torch.backends.cuda.matmul.allow_tf32 = on
  torch.backends.cudnn.allow_tf32 = on


def _mr_serve_480(mesh):
  """serve-480-2rank (see the phase's header)."""
  params = load_tapir_checkpoint(CHECKPOINT)
  video, qp = make_videos(1, MR_QUERIES, MR_FRAMES)[0]
  cells = {}
  for name, bf16 in (("fp32", False), ("bf16", True)):
    _mr_tf32(False)
    kw = dict(bfloat16=bf16, query_chunk_size=CHUNK,
              refinement_resolutions=[(RES, RES)])
    sharded = TapirPredictor(params, bootstapir_config(), mesh=mesh, **kw)
    sharded(video, qp)  # warm-up: cuDNN's choices, the allocator's growth
    got, rank = _mr_measure(lambda: sharded(video, qp))
    require(rank["launches"].get("corr_tents", 0) > 0
            and rank["launches"].get("mixer_block", 0) > 0,
            f"serve-480-2rank {name}: rank {mesh.rank} launched "
            f"{rank['launches']}")
    check = {}
    if mesh.rank == 0:
      want = TapirPredictor(params, bootstapir_config(), **kw)(video, qp)
      err = golden_errors(sharded, got, want)
      if bf16:
        tol = GOLDEN_BF16_TOL
        over = max(err["track_median_px"] / tol["median_px"],
                   err["track_p95_px"] / tol["p95_px"],
                   (1 - err["visible_agree"]) / (1 - tol["visible_agree"]))
      else:
        tol = dict(track_px=MR_FP32_PX, logits=GOLDEN_FP32_TOL["logits"])
        over = max(err["track_max_px"] / tol["track_px"],
                   err["logit_max_abs"] / tol["logits"])
      check = dict(errors=err, tol=tol, max_err_over_limit=over)
      require(over <= 1, f"serve-480-2rank {name}: {check}")
    cells[name] = dict(check=check, rank=rank)
    del sharded
    torch.cuda.empty_cache()
    torch.distributed.barrier()
  return cells


def _mr_serve_tapnext(mesh):
  """serve-tapnext-sp-2rank (see the phase's header)."""
  _mr_tf32(False)
  params = seeded_tapnext_params(SsmVitConfig(), TAPNEXT_SEED)
  video, qp = tapnext_videos(1, frames=MR_TN_FRAMES, queries=MR_TN_QUERIES)[0]
  sharded = TapnextPredictor(params, SsmVitConfig(), mesh=mesh)
  sharded(video, qp)
  got, rank = _mr_measure(lambda: sharded(video, qp))
  depth = SsmVitConfig().depth
  require(rank["launches"] == {"linear_scan": 2 * depth},
          f"serve-tapnext-sp-2rank: rank {mesh.rank} launched "
          f"{rank['launches']}, expected {2 * depth} K5 and nothing else")
  check = {}
  if mesh.rank == 0:
    want = TapnextPredictor(params, SsmVitConfig())(video, qp)
    axis_err = np.abs(got["tracks"] - want["tracks"]).max(-1)
    tol = TN_GOLDEN_FP32_TOL
    err = dict(track_max_px=float(axis_err.max()),
               share_within_px=float(np.mean(axis_err <= tol["track_px"])),
               occlusion_max_abs=float(np.abs(
                   got["occlusion"] - want["occlusion"]).max()))
    over = max((1 - err["share_within_px"]) / (1 - tol["share"]),
               err["occlusion_max_abs"] / tol["logits"])
    check = dict(errors=err, tol=tol, max_err_over_limit=over)
    require(over <= 1, f"serve-tapnext-sp-2rank: {check}")
  del sharded
  torch.cuda.empty_cache()
  torch.distributed.barrier()
  return dict(check=check, rank=rank)


def _mr_sp_scan(mesh):
  """sp-scan-grad (see the phase's header)."""
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  x, a, h0 = scan_inputs(TRAIN_SCAN_SHAPE, torch.float32, True, gen)
  gy = torch.randn(x.shape, device="cuda", generator=gen)
  gh = torch.randn(h0.shape, device="cuda", generator=gen)
  part = lambda v: sequence_lib.shard_time(v, mesh)
  xs = part(x).contiguous().requires_grad_()
  as_ = part(a).contiguous().requires_grad_()

  def sharded():
    y, h = sequence_lib.sequence_parallel_linear_scan(xs, as_, h0, mesh)
    # This rank's share of sum(y * gy) + sum(h * gh).
    ((y * part(gy)).sum() + (h * gh).sum() / mesh.size()).backward()
    return y.detach(), h.detach()

  (y, h), rank = _mr_measure(sharded)
  require(rank["launches"] == {"linear_scan": 2, "linear_scan_backward": 2},
          f"sp-scan-grad: rank {mesh.rank} launched {rank['launches']}")
  xr, ar = x.clone().requires_grad_(), a.clone().requires_grad_()
  y1, h1 = scan.linear_scan(xr, ar, h0)
  ((y1 * gy).sum() + (h1 * gh).sum()).backward()
  rel = lambda got, want: float(
      (got - want).detach().abs().max() / want.detach().abs().max())
  err = dict(y=rel(y, part(y1)), h_last=rel(h, h1), dx=rel(xs.grad, part(xr.grad)),
             da=rel(as_.grad, part(ar.grad)))
  check = dict(errors_rel=err, tol_rel=MR_SCAN_REL,
               max_err_over_limit=max(err.values()) / MR_SCAN_REL,
               shape=list(TRAIN_SCAN_SHAPE))
  require(check["max_err_over_limit"] <= 1, f"sp-scan-grad: {check}")
  del x, a, gy, xs, as_, xr, ar, y1
  torch.cuda.empty_cache()
  torch.distributed.barrier()
  return dict(check=check, rank=rank)


def _mr_train_step(mesh, exp, opt, batch):
  """One Trainer step of `exp` (over `mesh`, or one rank): (the gradients
  the optimizer received, the parameters after the step, its record)."""
  t = trainer_lib.Trainer(exp.build_model(), opt, exp.total_steps,
                          task=exp.task, loss_builder=exp.loss_builder,
                          device="cuda", mesh=mesh)
  state = t.init_state()
  grads = []
  update = t.tx.update
  t.tx.update = lambda g, s, p: (grads.append(g), update(g, s, p))[1]
  if mesh is not None:
    batch = mesh_lib.shard_batch(batch, mesh)
  (state, scalars), rank = _mr_measure(
      lambda: t.step_fn(state, batch, t.step_generator(0)))
  rank["loss"] = float(scalars["loss"])
  return grads[0], {k: p.detach() for k, p in state.params.items()}, rank


def _mr_train(mesh_of):
  """train-bootstapir-dp-2rank (see the phase's header)."""
  _mr_tf32(False)
  exp = train_configs.bootstapir_experiment()
  opt = dataclasses.replace(exp.optimizer, warmup_steps=0)
  res = exp.model_config.initial_resolution
  batch = next(synthetic.batch_iterator(
      seed=SEED, device="cuda", batch_size=MR_TRAIN_BATCH,
      num_frames=TRAIN_TAPIR_FRAMES, height=res[0], width=res[1],
      num_queries=MR_TRAIN_QUERIES))
  sharded, cells = {}, {}
  for mp in (1, 2):
    mesh = mesh_of(mp)
    grads, params, rank = _mr_train_step(mesh, exp, opt, batch)
    require(rank["launches"].get("corr_tents", 0) > 0
            and rank["launches"].get("mixer_block", 0) > 0,
            f"train-bootstapir-dp-2rank mp={mp}: rank {mesh.rank} launched "
            f"{rank['launches']}")
    sharded[mp] = (grads, params)
    cells[f"model_parallel_{mp}"] = dict(check={}, rank=rank)
    torch.cuda.empty_cache()
  if mesh_of(1).rank == 0:
    g1, p1, _ = _mr_train_step(None, exp, opt, batch)
    gen = torch.Generator(device="cuda").manual_seed(tapir_golden.NUDGE_SEED)
    sign = torch.randint(0, 2, batch["video"].shape, device="cuda",
                         generator=gen) * 2 - 1
    nudged = dict(batch, video=batch["video"] * (
        1 + tapir_golden.NUDGE_REL * sign))
    gn, _, _ = _mr_train_step(None, exp, opt, nudged)
    big = max(float(g.abs().max()) for g in g1.values())
    limit = {k: (tapir_golden.GRAD_REL * float(g.abs().max())
                 + tapir_golden.GRAD_FLOOR * big
                 + tapir_golden.WITNESS_FACTOR * float((gn[k] - g).abs().max()))
             for k, g in g1.items()}
    # Adam's first step moves a parameter by lr * m / (sqrt(v) + eps), so
    # a gradient d apart moves it by at most lr * min(2, 2 d / (|g| - d)).
    lr = optimizers_lib.make_lr_schedule(opt, exp.total_steps)(0)
    for mp, (grads, params) in sharded.items():
      g_over = max(float((grads[k] - g).abs().max()) / limit[k]
                   for k, g in g1.items())
      # A first Adam step moves a parameter by about lr whatever |g| is, so
      # a gradient within its limit of zero that changes sign moves it by
      # 2 lr, at its limit: those are counted, and the largest error over
      # the limit is also given without them.
      p_over, rest_over, flipped = 0.0, 0.0, 0
      for k, p in p1.items():
        d = limit[k]
        du = torch.clamp(2 * d / (torch.clamp(g1[k].abs() - d, min=0)
                                  + opt.adam_eps), max=2.0)
        plimit = tapir_golden.PARAM_REL * p.abs() + lr * du
        apart = (params[k] - p).abs()
        over = apart / plimit
        flips = apart > lr
        flipped += int(flips.sum())
        p_over = max(p_over, float(over.max()))
        rest_over = max(rest_over, float(torch.where(flips, 0.0, over).max()))
      check = dict(grads_over_limit=g_over, params_over_limit=p_over,
                   params_flipped=flipped,
                   params_over_limit_unflipped=rest_over,
                   max_err_over_limit=max(g_over, p_over), learning_rate=lr,
                   nudge_witness_max=max(float((gn[k] - g).abs().max())
                                         for k, g in g1.items()))
      cells[f"model_parallel_{mp}"]["check"] = check
      require(check["max_err_over_limit"] <= 1,
              f"train-bootstapir-dp-2rank mp={mp}: {check}")
  torch.cuda.empty_cache()
  torch.distributed.barrier()
  return cells


def _mr_rank(rank, world, device):
  """One rank of the multi_rank phase: every cell, in order."""
  del rank, world, device
  meshes = {}

  def mesh_of(model_parallel):
    if model_parallel not in meshes:
      meshes[model_parallel] = mesh_lib.make_mesh(model_parallel)
    return meshes[model_parallel]

  out = {}
  for name, cell in (("serve_480_2rank", _mr_serve_480),
                     ("serve_tapnext_sp_2rank", _mr_serve_tapnext),
                     ("sp_scan_grad", _mr_sp_scan)):
    out[name] = cell(mesh_of(1))
  out["train_bootstapir_dp_2rank"] = _mr_train(mesh_of)
  return out


def multi_rank():
  """The multi_rank phase (see its header): one spawn of MR_RANKS ranks on
  the one card. A failure of any rank fails the phase."""
  torch.cuda.empty_cache()
  start = time.perf_counter()
  # gloo, not NCCL: the ranks share the one card, and NCCL refuses two ranks
  # on one card.
  ranks = launch_lib.run_ranks(_mr_rank, MR_RANKS, "gloo", "cuda",
                               timeout=900)
  wall = time.perf_counter() - start

  def merged(name, records):
    """A cell's check (rank 0's) with every rank's launches, wall and peak
    memory, printed on one line."""
    cell = dict(records[0]["check"], per_rank=[r["rank"] for r in records])
    print(f"multi_rank {name}: {cell.get('max_err_over_limit', 0):.4g} of "
          f"its limit; per rank " + "; ".join(
              f"{r['launches']}, {r['wall_s']:.3f} s, "
              f"{r['peak_memory_gb']:.2f} GB" for r in cell["per_rank"]),
          flush=True)
    return cell

  cells = {}
  for name, value in ranks[0].items():
    if "check" in value:
      cells[name] = merged(name, [r[name] for r in ranks])
    else:
      cells[name] = {sub: merged(f"{name}/{sub}", [r[name][sub] for r in ranks])
                     for sub in value}
  print(f"multi_rank: {MR_RANKS} ranks sharing one card over gloo (NCCL "
        f"refuses two ranks on one card): the times are of ranks sharing a "
        f"card, not a multi-GPU speed; phase {wall:.1f} s "
        f"(budget {MR_BUDGET_S} s)", flush=True)
  return dict(note="two ranks share one H100 over gloo; times are not a "
                   "multi-GPU speed", ranks=MR_RANKS, backend="gloo",
              wall_s=wall, budget_s=MR_BUDGET_S, cells=cells)


RECORDS = None


# ------------------------------------------------------------------- phase 9


def _only_k1(counts, per, what):
  require({k: v for k, v in counts.items() if v} == {"corr_tents": per},
          f"{what}: launches {counts}, expected {per} K1 launches and no "
          "other kernel")


def dense_golden_check(params):
  """dense-golden: the port's track_many_points (trained causal BootsTAPIR)
  on the golden clip against JAX's (tools/make_dense_golden.py), fp32 with
  TF32 off under GOLDEN_FP32_TOL and the flags equal but near the
  threshold, bf16 under GOLDEN_BF16_TOL; 12 K1 launches a streamed frame."""
  golden = np.load(make_dense_golden.OUT)
  video = np.load(make_dense_golden.CLIP)["video"][0]
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  result = {}
  for name in ("float32", "bfloat16"):
    reset_counts()
    out = dense_tracking.track_many_points(
        video, params, causal_bootstapir_config(compute_dtype=name),
        num_points=make_dense_golden.NUM_POINTS, seed=make_dense_golden.SEED)
    _only_k1(read_counts(), ONLINE_K1_PER_STEP * video.shape[0],
             f"dense-golden {name}")
    require(np.array_equal(out["query_points"], golden["query_points"]),
            "dense-golden: the query points differ from JAX's")
    r = result[name] = make_dense_golden.golden_apart(
        out, golden, GOLDEN_FP32_TOL["logits"])
    if name == "float32":
      ok = (r["track_max_px"] <= GOLDEN_FP32_TOL["tracks"]
            and r["logit_max_abs"] <= GOLDEN_FP32_TOL["logits"]
            and r["flags_apart_elsewhere"] == 0)
    else:
      ok = within_bf16(r)
    require(ok, f"dense-golden {name}: {r} vs "
            f"{GOLDEN_BF16_TOL if name == 'bfloat16' else GOLDEN_FP32_TOL}")
  torch.backends.cudnn.allow_tf32 = True
  return result


def robotap_videos(count, frames=ROBOTAP_FRAMES, res=TN_RES):
  """uint8 [frames, res, res, 3] clips of the synthetic renderer (seeded)."""
  gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
  return [((synthetic.make_batch(gen, 1, frames, res, res, 8)["video"][0]
            + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8).cpu().numpy()
          for _ in range(count)]


def _synced_s(fn):
  """Host seconds of fn(), from an idle device to the device's end."""
  torch.cuda.synchronize()
  start = time.perf_counter()
  fn()
  torch.cuda.synchronize()
  return time.perf_counter() - start


def robotap_dense_256(params):
  """robotap-dense-256: track_many_points as RoboTAP runs it (module
  head), a warm-up video, ROBOTAP_TIMED timed ones: per video the call's
  seconds, the seconds of its query-feature extraction (the module's
  _query_feature_banks on the same video and query points, timed alone),
  the stream's ms a frame by the host clock (the call less the query
  features, over the frames), peak memory and the K1 launches (12 a frame
  and no other kernel); then profiles of a ROBOTAP_PROFILE_FRAMES-frame
  call and of its query features alone: the stream's device ms a frame
  (the call's kernel time less the query features', over the frames) and
  the device's busy share of the call."""
  _pytorch_tf32_defaults()
  cfg = causal_bootstapir_config()
  model = tapir_lib.TAPIR(cfg)
  convert_lib.load_flax_params(model, params)
  model = model.cuda().eval()

  def query_features(video, seed):
    """The call's query-feature extraction for `video` at `seed`."""
    points = dense_tracking.sample_grid_points(
        np.random.RandomState(seed), *video.shape[:3], ROBOTAP_POINTS)
    frames = torch.from_numpy(
        video.astype(np.float32) / 255.0 * 2.0 - 1.0).cuda()

    def run():
      with torch.inference_mode():
        dense_tracking._query_feature_banks(model, frames, points)  # pylint: disable=protected-access
    return run

  videos = robotap_videos(1 + ROBOTAP_TIMED)
  track = lambda video, seed=0: dense_tracking.track_many_points(
      video, params, cfg, num_points=ROBOTAP_POINTS, seed=seed)
  track(videos[0])
  query_features(videos[0], 0)()
  records = []
  for i, video in enumerate(videos[1:]):
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    outs = []
    wall = _synced_s(lambda v=video, i=i: outs.append(track(v, i)))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    out = outs[0]
    _only_k1(counts, ONLINE_K1_PER_STEP * ROBOTAP_FRAMES, "robotap-dense-256")
    qt = out["query_points"][:, 0].astype(int)
    require(out["tracks"].shape == (ROBOTAP_POINTS, ROBOTAP_FRAMES, 2)
            and np.isfinite(out["tracks"]).all()
            and np.abs(out["tracks"]).max() < 4 * TN_RES
            and not (out["visibility"]
                     & (np.arange(ROBOTAP_FRAMES)[None] < qt[:, None])).any(),
            "robotap-dense-256: bad tracks or flags")
    query_s = _synced_s(query_features(video, i))
    records.append(dict(
        wall_s=wall, query_features_s=query_s,
        query_frames=int(len(np.unique(qt))),
        ms_per_frame_host=(wall - query_s) * 1e3 / ROBOTAP_FRAMES,
        peak_memory_gb=peak / 1e9,
        k1_launches_per_frame=counts["corr_tents"] / ROBOTAP_FRAMES,
        visible_share=float(out["visibility"].mean())))
  short = videos[1][:ROBOTAP_PROFILE_FRAMES]
  call = lambda: track(short)
  short_wall = _synced_s(call)
  profile = profile_request(call, short_wall, top=10)
  short_query = query_features(short, 0)
  query_profile = profile_request(short_query, _synced_s(short_query), top=5)
  mean = lambda key: float(np.mean([r[key] for r in records]))
  return dict(
      config=dict(model="causal_bootstapir_config()", compute_dtype="float32",
                  tf32="PyTorch defaults: cuDNN on, matmul off",
                  weights="runs/bootstapir_synth/trained_params_f16.npy",
                  video=f"data/synthetic.py sprites, seed {SEED + 16}"),
      frames=ROBOTAP_FRAMES, points=ROBOTAP_POINTS, resolution=TN_RES,
      videos=records, ms_per_frame_host_mean=mean("ms_per_frame_host"),
      ms_per_frame_device=(profile["device_ms"] - query_profile["device_ms"])
      / ROBOTAP_PROFILE_FRAMES,
      query_features_s_mean=mean("query_features_s"),
      launches_per_video=counts,
      profile_frames=ROBOTAP_PROFILE_FRAMES, profile_wall_s=short_wall,
      profile=profile, query_features_profile=query_profile)


def planted_rigid_tracks(n=CLUSTER_TRACKS, t=ROBOTAP_FRAMES,
                         groups=CLUSTER_GROUPS, res=TN_RES, seed=SEED):
  """(tracks [n, t, 2] px, visibility [n, t], group [n]): each group's
  points on a plane at its own depth, moved by a smooth 4-DoF rigid motion
  (in-plane rotation, 2D translation, depth) and seen by a pinhole camera
  (focal length res), with noise and random occlusion. Every group's points
  are drawn from one image region, where all groups lie interleaved at the
  first frame (their centroids within 2 px): then each leaves along its own
  direction, as objects taken from a pile, so no split by the position at
  the first frame separates them."""
  rng = np.random.RandomState(seed)
  group = np.arange(n) % groups
  local = rng.uniform(-0.12, 0.12, (n, 2))
  ts = np.arange(t) / t
  smooth = lambda amp: sum(a * np.sin(2 * np.pi * f * ts + p) for a, f, p in
                           zip(rng.uniform(0, amp, 3), rng.uniform(0.3, 1.5, 3),
                               rng.uniform(0, 2 * np.pi, 3)))
  leave = np.arange(t) / (t - 1)
  tracks = np.zeros((n, t, 2))
  for g in range(groups):
    sel = group == g
    heading = np.pi / 4 + 2 * np.pi * g / groups
    # Depth within the range the model's depth clamp ([0.5, 2] about 1)
    # can follow, rotation within a manipulated object's.
    angle, wx, wy = smooth(0.2), smooth(0.1), smooth(0.1)
    depth = 2.0 + smooth(0.1)
    tx = 0.35 * np.cos(heading) * leave + wx - wx[0]
    ty = 0.35 * np.sin(heading) * leave + wy - wy[0]
    cos, sin = np.cos(angle), np.sin(angle)
    x = local[sel, 0:1] * cos - local[sel, 1:2] * sin + tx
    y = local[sel, 0:1] * sin + local[sel, 1:2] * cos + ty
    tracks[sel] = np.stack([x, y], -1) * res / depth[None, :, None] + res / 2
  tracks += rng.randn(*tracks.shape) * CLUSTER_NOISE_PX
  vis = (rng.rand(n, t) > CLUSTER_OCCLUDED).astype(np.float32)
  return tracks.astype(np.float32), vis, group


def cluster_purity(classes, group):
  """(purity of each recovered cluster, the groups that are no cluster's
  majority)."""
  purity, majority = {}, set()
  for c in np.unique(classes):
    counts = np.bincount(group[classes == c], minlength=group.max() + 1)
    purity[int(c)] = float(counts.max() / counts.sum())
    majority.add(int(counts.argmax()))
  return purity, sorted(set(range(group.max() + 1)) - majority)


def robotap_cluster():
  """robotap-cluster: compute_clusters at its default widths on planted
  rigid tracks of the dense cell's size, iters_before_split cut to
  CLUSTER_ITERS_BEFORE_SPLIT: every cluster at least CLUSTER_PURITY pure,
  no group absent, and a split by the first frame's position below that
  purity; ms a step and total seconds."""
  tracks, vis, group = planted_rigid_tracks()
  t = tracks.shape[1]
  first = tracks[:, 0]
  quadrant = 2 * (first[:, 0] > np.median(first[:, 0])) + (
      first[:, 1] > np.median(first[:, 1]))
  control = min(cluster_purity(quadrant, group)[0].values())
  require(control < CLUSTER_PURITY,
          f"robotap-cluster: a split by the first frame's position reaches "
          f"purity {control}: the planted groups do not overlap")
  torch.cuda.synchronize()
  reset_counts()
  start = time.perf_counter()
  out = clustering.compute_clusters(
      {"demo": tracks}, {"demo": vis}, ["demo"],
      {"demo": (t, TN_RES, TN_RES, 3)},
      iters_before_split=CLUSTER_ITERS_BEFORE_SPLIT, verbose=False)
  total = time.perf_counter() - start
  purity, absent = cluster_purity(out["classes"], group)
  require(min(purity.values()) >= CLUSTER_PURITY and not absent,
          f"robotap-cluster: purity {purity}, groups absent {absent}")
  return dict(
      tracks=int(tracks.shape[0]), frames=t, groups=CLUSTER_GROUPS,
      widths=dict(point_sample=2048, frame_sample=1024, final_num_cats=15,
                  max_num_cats=25, fourdof=True),
      iters_before_split=CLUSTER_ITERS_BEFORE_SPLIT,
      steps=out["num_steps"], total_s=total,
      ms_per_step=total * 1e3 / out["num_steps"],
      clusters=len(purity), purity=purity, min_purity=min(purity.values()),
      first_frame_quadrants_min_purity=control,
      sizes={int(c): int((out["classes"] == c).sum())
             for c in np.unique(out["classes"])},
      launches=read_counts())


def smooth_flow(steps=FLOW_FRAMES - 1, res=FLOW_RES, seed=SEED):
  """[steps, res, res, 2] float32 flow (dx, dy): sums of a few sinusoids in
  space and time, a few px a frame."""
  rng = np.random.RandomState(seed)
  yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
  flow = np.zeros((steps, res, res, 2), np.float64)
  for c in range(2):
    for _ in range(4):
      kx, ky = rng.uniform(-2, 2, 2) * 2 * np.pi / res
      amp, phase = rng.uniform(0.25, 1.0), rng.uniform(0, 2 * np.pi)
      speed = rng.uniform(-0.2, 0.2)
      for t in range(steps):
        flow[t, :, :, c] += amp * np.sin(kx * xx + ky * yy + phase + speed * t)
  return flow.astype(np.float32)


def _cpu_candidates(cost, flow, radius, y, x):
  """The CPU step's (2r+1)^2 candidates at pixel (y, x), in its float32
  arithmetic (flow_track_assist.dp_step), raster order."""
  window = 2 * radius + 1
  costp = np.pad(cost, radius, constant_values=np.float32(flow_track_assist._BIG))  # pylint: disable=protected-access
  flowp = np.pad(flow, ((radius, radius), (radius, radius), (0, 0)))
  d = np.arange(window, dtype=np.float32) - radius
  c = costp[y:y + window, x:x + window]
  f = flowp[y:y + window, x:x + window]
  sq = np.square(f[..., 0] + d[None, :]) + np.square(f[..., 1] + d[:, None])
  return (np.sqrt(sq.astype(np.float32)) + c).reshape(-1)


def flow_assist():
  """flow-assist: interpolate_track on the card at FLOW_RADII against the
  plain CPU run of the same steps on the same flow (FLOW_COST_RTOL on the
  final cost map; the card's argmins along its own track equal the CPU's
  but at the CPU's near ties, counted); seconds a track."""
  flows = smooth_flow()
  start = (FLOW_RES // 2, FLOW_RES // 2)
  end = tuple(int(round(v)) for v in np.clip(
      flow_track_assist.chain_flow(flows, start)[-1], 0, FLOW_RES - 1))
  h = w = FLOW_RES
  init = np.full((h, w), flow_track_assist._BIG, np.float32)  # pylint: disable=protected-access
  init[start[1], start[0]] = 0.0
  result = {}
  for radius in FLOW_RADII:
    window = 2 * radius + 1
    flow_track_assist.interpolate_track(flows, start, end, radius)  # warm-up
    torch.cuda.synchronize()
    begin = time.perf_counter()
    track = flow_track_assist.interpolate_track(flows, start, end, radius)
    card_s = time.perf_counter() - begin
    with torch.inference_mode():
      cost_card, arg_card = flow_track_assist._dp_forward(  # pylint: disable=protected-access
          torch.from_numpy(flows).cuda(), torch.from_numpy(init).cuda(), radius)
      cost_card, arg_card = cost_card.cpu().numpy(), arg_card.cpu().numpy()
      begin = time.perf_counter()
      costs, args, cost = [], [], torch.from_numpy(init)
      for t in range(flows.shape[0]):
        costs.append(cost.numpy())
        cost, arg = flow_track_assist.dp_step(cost, torch.from_numpy(flows[t]),
                                              radius)
        args.append(arg.numpy())
      cpu_s = time.perf_counter() - begin
    arg_cpu = np.stack(args)
    cost_cpu = cost.numpy()
    track_cpu = flow_track_assist.backtrack(arg_cpu, end, radius)
    reach = cost_cpu < flow_track_assist._BIG  # pylint: disable=protected-access
    cost_rel = float((np.abs(cost_card - cost_cpu)[reach]
                      / np.abs(cost_cpu[reach])).max())
    near_ties, faults = [], []
    for t in range(flows.shape[0] - 1, -1, -1):
      px, py = (int(v) for v in track[t + 1])
      k_card, k_cpu = arg_card[t, py, px], arg_cpu[t, py, px]
      if k_card == k_cpu:
        continue
      cand = _cpu_candidates(costs[t], flows[t], radius, py, px)
      require(int(np.argmin(cand)) == k_cpu,
              f"flow-assist: the CPU's candidates at step {t} disagree with "
              "its argmin")
      best, second = np.sort(cand)[:2]
      near = abs(cand[k_card] - cand[k_cpu]) <= FLOW_COST_RTOL * abs(best)
      (near_ties if near else faults).append(dict(
          step=t, pixel=(px, py), card=int(k_card), cpu=int(k_cpu),
          best=float(best), second=float(second)))
    r = result[f"radius_{radius}"] = dict(
        window_offsets=window * window, card_s_per_track=card_s,
        cpu_s_per_track=cpu_s, final_cost_max_rel=cost_rel,
        argmins_apart_in_map=int((arg_card != arg_cpu).sum()),
        track_equal=bool(np.array_equal(track, track_cpu)),
        track_max_px_apart=float(np.abs(track - track_cpu).max()),
        near_tie_steps=near_ties, faults=faults,
        end_reached=bool(np.array_equal(track[-1], end)))
    require(cost_rel <= FLOW_COST_RTOL and not faults
            and (r["track_equal"] or near_ties),
            f"flow-assist radius {radius}: {r}")
  return dict(resolution=FLOW_RES, frames=FLOW_FRAMES, start=start, end=end,
              **result)


def kubric_examples(count=KUBRIC_EXAMPLES, frames=TRAIN_TAPIR_FRAMES,
                    hw=KUBRIC_HW):
  """Kubric-layout examples of the synthetic renderer on the card (uint8
  video [T, H, W, 3], target_points [N, T, 2], occluded [N, T])."""
  gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
  for _ in range(count):
    b = synthetic.make_batch(gen, 1, frames, hw[0], hw[1], 64)
    yield dict(
        video=((b["video"][0] + 1.0) * 127.5).round().clamp(0, 255)
        .to(torch.uint8).cpu().numpy(),
        target_points=b["target_points"][0].cpu().numpy(),
        occluded=b["occluded"][0].cpu().numpy() > 0.5)


def train_kubric_256():
  """train-kubric-256: write_examples writes made-up examples, and the
  training CLI's data path (run.make_data, --data_dir) feeds
  bootstapir_experiment() at its own data size through the Kubric reader
  (a host thread, resize, query sampling and colour augmentation on the
  card): a warm-up step and KUBRIC_STEPS timed ones, each with the time
  its batch took (the reader's wait and the preparation on the card), K1
  and K3 launches as `_tapir_launches` counts, and a finite loss."""
  _pytorch_tf32_defaults()
  shutil.rmtree(KUBRIC_DIR, ignore_errors=True)
  begin = time.perf_counter()
  written = kubric_convert.write_examples(kubric_examples(), KUBRIC_DIR)
  write_s = time.perf_counter() - begin
  try:
    args = run_lib.make_parser().parse_args(
        ["--experiment", "bootstapir", "--data_dir", KUBRIC_DIR,
         "--seed", str(SEED)])
    exp = train_configs.get_experiment(args.experiment)
    cfg = exp.model_config
    data = run_lib.make_data(args, exp, torch.device("cuda"))
    t = trainer_lib.Trainer(exp.build_model(), exp.optimizer, exp.total_steps,
                            task=exp.task, loss_builder=exp.loss_builder,
                            device="cuda")
    state = t.init_state()
    expected = _tapir_launches(
        cfg, -(-exp.data.num_queries // exp.task.train_chunk_size))
    records = []
    for i in range(1 + KUBRIC_STEPS):
      torch.cuda.synchronize()
      begin = time.perf_counter()
      batch = next(data)
      torch.cuda.synchronize()
      batch_ms = (time.perf_counter() - begin) * 1e3
      require(tuple(batch["video"].shape) == (
          exp.data.batch_size, exp.data.num_frames) + tuple(
              exp.data.train_size) + (3,), f"train-kubric: batch "
              f"{tuple(batch['video'].shape)}")
      state, rec = _timed_step(t, state, batch, "train-kubric")
      launches = {k: v for k, v in rec["launches"].items() if v}
      require(launches == expected,
              f"train-kubric: launches {launches}, expected {expected}")
      rec.update(batch_ms=batch_ms, reader_wait_ms=data.reader.wait_s * 1e3)
      records.append(rec)
  finally:
    shutil.rmtree(KUBRIC_DIR, ignore_errors=True)
  timed = records[1:]
  return dict(
      config=dict(experiment="bootstapir_experiment()",
                  data=f"{written} examples written by write_examples: the "
                  f"synthetic renderer, seed {SEED + 17}, {TRAIN_TAPIR_FRAMES} "
                  f"frames of {KUBRIC_HW[0]}x{KUBRIC_HW[1]}",
                  weights="init_tapir_params seed 42 (Trainer.init_state)",
                  tf32="PyTorch defaults: cuDNN on, matmul off"),
      write_s=write_s, batch=exp.data.batch_size, frames=exp.data.num_frames,
      queries=exp.data.num_queries, resolution=exp.data.train_size[0],
      warm_up=records[0], steps=timed,
      ms_per_step_mean=float(np.mean([r["ms"] for r in timed])),
      batch_ms_mean=float(np.mean([r["batch_ms"] for r in timed])),
      reader_wait_ms_mean=float(np.mean([r["reader_wait_ms"] for r in timed])),
      max_memory_gb=max(r["max_memory_gb"] for r in timed),
      launches_per_step=timed[-1]["launches"])


def multi_rank_launches(counter, runs):
  """{cell: [launches on each rank]} of `counter` in the multi_rank phase
  (only the cells that launched it)."""
  out = {}
  for name, cell in runs["multi_rank"]["cells"].items():
    subs = {name: cell} if "per_rank" in cell else {
        f"{name}/{sub}": v for sub, v in cell.items()}
    for key, sub in subs.items():
      counts = [r["launches"].get(counter, 0) for r in sub["per_rank"]]
      if any(counts):
        out[key] = counts
  return out


def launches_in(meta, counter, per, runs):
  """A kernel's launches in the runs besides the one that drives it: its
  `also_runs` (per video or step) and, per rank, the multi_rank phase's."""
  out = {run: runs[run][f"launches_per_{per}"][counter]
         for run in (meta["run"], *meta.get("also_runs", ()))}
  ranks = multi_rank_launches(counter, runs)
  if ranks:
    out["multi_rank"] = ranks
  return out


def emit(record):
  """Prints a record as one JSON line (and appends it to RECORDS)."""
  line = json.dumps(record)
  print(line, flush=True)
  if RECORDS:
    with open(RECORDS, "a", encoding="utf-8") as f:
      f.write(line + "\n")


def main():
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)
  card = card_line()
  print(card, flush=True)
  if RECORDS:
    os.makedirs(os.path.dirname(os.path.abspath(RECORDS)), exist_ok=True)
    with open(RECORDS, "w", encoding="utf-8") as f:
      f.write(json.dumps({"card": card}) + "\n")
  t0 = time.perf_counter()
  built = _build.build_all()
  build_s = time.perf_counter() - t0
  print(f"built {built} in {build_s:.1f} s", flush=True)

  def stamp(what):
    elapsed = time.perf_counter() - t0
    print(f"[{elapsed:.1f} s] {what} done", flush=True)
    if RECORDS:
      with open(RECORDS, "a", encoding="utf-8") as f:
        f.write(json.dumps({"stamp": what, "s": elapsed}) + "\n")

  checks = check_kernels()
  emit({"kernel_checks": checks})
  stamp("kernel checks")

  params = load_tapir_checkpoint(CHECKPOINT)
  golden = golden_check(params)
  emit({"golden": golden})
  golden_int8, golden_int8_launches = golden_check_int8(params)
  emit({"golden_int8": golden_int8, "launches": golden_int8_launches})
  stamp("BootsTAPIR golden checks")
  emit({"eval_synth": eval_synth(params), "card": card})
  stamp("eval-synth")

  videos = make_videos(4)
  fast = dict(num_pips_iter=2)
  runs = {
      # serve-480: the full-precision configuration.
      "serve": serve(params, videos, {}, ("corr_tents", "mixer_block")),
      # serve-480-fp32: the same in the predictor's default float32: K1 and
      # K3 in float32, K3's products as error-compensated TF32.
      "serve_fp32": serve(params, videos, {}, ("corr_tents", "mixer_block"),
                          bfloat16=False),
      # serve-480-int8: w8a8 mixer, per-frame int8 correlation, 2 steps.
      "serve_int8": serve(
          params, videos, dict(INT8_CONFIGS["a"], **fast),
          ("corr_tents_q8_frame", "mixer_block_q8")),
      # The same step count in bf16, to tell int8's share from the steps'.
      "serve_bf16_2iter": serve(
          params, videos, fast, ("corr_tents", "mixer_block")),
      # serve-480-int8-b: per-position int8 correlation (K2b) at the shapes
      # phase 2 checks it at, two videos after the warm-up.
      "serve_int8_b": serve(
          params, videos[:3], INT8_CONFIGS["b"],
          ("corr_tents_q8_position", "corr_quantize", "mixer_block")),
      # serve-480-headline: the JAX package's headline (bench.py) at its full
      # size, 1024 queries; per-frame int8 ExtraConvs (X), K2 and K4.
      "serve_headline": serve(
          params, make_videos(3, HEADLINE_QUERIES), INT8_CONFIGS["c"],
          ("corr_tents_q8_frame", "mixer_block_q8", "extra_convs_q8_frame"),
          queries=HEADLINE_QUERIES),
      # serve-480-int8-pp: serve-480-int8 with the per-pixel int8
      # ExtraConvs: K6 at both grids, no per-frame conv.
      "serve_int8_pp": serve(
          params, videos[:3],
          dict(INT8_CONFIGS["a"], quantized_extra_convs="per_pixel", **fast),
          ("corr_tents_q8_frame", "mixer_block_q8", "extra_convs_q8_pixel")),
  }
  tracks = {name: run.pop("tracks") for name, run in runs.items()}
  # The float32 products run on the tensor-core GEMM, and no SIMT one is left.
  fp32_kernels = [k["name"] for k in runs["serve_fp32"]["profile"]["own_kernels"]]
  require(any("mixer_gemm_tma<0, float>" in k for k in fp32_kernels)
          and any("mixer_gemm_tma<1, float>" in k for k in fp32_kernels)
          and not any("mixer_gemm_f32" in k for k in fp32_kernels),
          f"serve-480-fp32's mixer products: {fp32_kernels}")
  runs["serve_fp32"]["tracks_vs_bf16"] = tracks_apart(
      tracks["serve_fp32"], tracks["serve"])
  runs["serve_int8"]["tracks_vs_bf16_same_steps"] = tracks_apart(
      tracks["serve_int8"], tracks["serve_bf16_2iter"])
  for name, run in runs.items():
    emit({name: run, "card": card})
  stamp("BootsTAPIR serving")
  runs["extra_convs_fp_480"] = extra_convs_fp_480(params, videos[:3])
  emit({"extra_convs_fp_480": runs["extra_convs_fp_480"], "card": card})
  stamp("extra-convs-fp-480")
  del videos
  torch.cuda.empty_cache()

  emit({"online_golden": online_golden_check(params)})
  emit({"online_golden_int8": online_golden_check_int8(params)})
  stamp("online golden checks")
  causal_params = {k: v for k, v in params.items() if k != "extra"}
  for name, phase in (
      ("online_tapir_256", lambda: online_tapir(
          causal_params, causal_tapir_config(compute_dtype="bfloat16"))),
      ("online_bootstapir_256", lambda: online_tapir(
          params, causal_bootstapir_config())),
      ("online_bootstapir_256_int8", lambda: online_tapir(
          params, causal_bootstapir_config(**INT8_CONFIGS["c"]),
          ONLINE_INT8_PER_STEP))):
    runs[name] = phase()
    emit({name: runs[name], "card": card})
    stamp(name)

  del params, causal_params
  tn_params = seeded_tapnext_params(SsmVitConfig(), TAPNEXT_SEED)
  emit({"tapnext_golden": tapnext_golden_check(tn_params)})
  stamp("TAPNext golden checks")
  for name, phase in (("serve_tapnext", serve_tapnext),
                      ("online_tapnext", online_tapnext)):
    runs[name] = phase(tn_params)
    emit({name: runs[name], "card": card})
    stamp(name)
  del tn_params
  torch.cuda.empty_cache()

  runs["multi_rank"] = multi_rank()
  emit({"multi_rank": runs["multi_rank"], "card": card})
  stamp("multi_rank")

  emit({"train_golden": train_golden_check()})
  stamp("train-golden")
  for name, phase in (("train_tapnext_256", train_tapnext_256),
                      ("train_tapnextpp", train_tapnextpp)):
    runs[name] = phase()
    emit({name: runs[name], "card": card})
    stamp(name)
    torch.cuda.empty_cache()

  emit({"tapnet_golden": tapnet_golden_check(), "card": card})
  stamp("tapnet-golden")
  emit({"trajan_golden": trajan_golden_check(), "card": card})
  stamp("trajan-golden")
  for name, phase in (("train_tapnet_256", train_tapnet_256),
                      ("serve_trajan_150", serve_trajan_150)):
    runs[name] = phase()
    emit({name: runs[name], "card": card})
    stamp(name)
    torch.cuda.empty_cache()

  emit({"train_golden_tapir": train_golden_tapir(), "card": card})
  stamp("train-golden-tapir")
  emit({"bootstrap_golden": train_golden_tapir(("bootstrap",)), "card": card})
  stamp("bootstrap-golden")
  for name, phase in (
      ("train_bootstapir_256", train_bootstapir_256),
      ("train_bootstapir_synth", train_bootstapir_synth),
      ("train_bootstrap_256",
       lambda: train_bootstrap_256(load_tapir_checkpoint(CHECKPOINT)))):
    runs[name] = phase()
    emit({name: runs[name], "card": card})
    stamp(name)
    torch.cuda.empty_cache()

  params = load_tapir_checkpoint(CHECKPOINT)
  emit({"dense_golden": dense_golden_check(params), "card": card})
  stamp("dense-golden")
  for name, phase in (("robotap_dense_256", lambda: robotap_dense_256(params)),
                      ("robotap_cluster", robotap_cluster),
                      ("flow_assist", flow_assist),
                      ("train_kubric_256", train_kubric_256)):
    runs[name] = phase()
    emit({name: runs[name], "card": card})
    stamp(name)
    torch.cuda.empty_cache()
  del params

  # One row per kernel: bf16 model dtype (the served precision; K5's inputs
  # stay float32 in it), and K3 and K1 in float32 too (the predictor's
  # default, serve-480-fp32), per launch at the served shapes, with the
  # launches per video of the run that drives it. launches * ms should come near the
  # profile's time for the kernel's layer (corr-tents in -int8-b: with
  # corr_quantize's launches).
  kernels = []
  for name, meta in KERNEL_META.items():
    dtype = meta.get("dtype", "bfloat16")
    counter = meta.get("counter", name)
    row = next(c for c in checks if c["kernel"] == counter
               and c["dtype"] == dtype and c.get("path"))
    per = meta.get("per", "video")
    launches = runs[meta["run"]][f"launches_per_{per}"][counter]
    profile_ms = runs[meta["run"]]["profile"]["by_layer_ms"][meta["layer"]]
    require(launches > 0, f"{name} never launched on its path")
    # K1 at another run's shapes (robotap-dense-256: 1024 queries), held
    # against its plain version there too.
    at_runs = {c["path_of"]: {k: c[k] for k in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
        "max_err_over_limit", "tol")} for c in checks
               if c["kernel"] == counter and c["dtype"] == dtype
               and "path_of" in c}
    kernels.append(dict(
        name=name, route="cuda", source=meta["source"],
        replaces=meta["replaces"], tpu_kernel=meta["tpu_kernel"],
        **({"loop": meta["loop"]} if "loop" in meta else {}),
        launches=launches, launches_from=meta["run"], launches_per=per,
        max_abs_err=row["max_abs_err"],
        max_err_over_limit=row["max_err_over_limit"], tol=row["tol"],
        ms=row["ms"], kernel_ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
        shape=row["shape"], dtype=dtype,
        **{f"profile_ms_per_{per}": profile_ms},
        # K4: its launches in the JAX headline's run too.
        **({"launches_in": launches_in(meta, counter, per, runs)}
           if "also_runs" in meta or multi_rank_launches(counter, runs)
           else {}),
        **({"at_runs": at_runs} if at_runs else {}),
        **({"split_ms": row["split_ms"]} if "split_ms" in row else {}),
        **({"ms_by_grid": row["ms_by_grid"],
            "split_ms_by_grid": row["split_ms_by_grid"]}
           if "ms_by_grid" in row else {}),
        # X: cuDNN's bf16 convolution of the same shapes; K3: cuBLAS's two
        # bare products (fp32: TF32 off); for context only.
        **({"cudnn_same_shape_ms": row["cudnn_same_shape_ms"]}
           if "cudnn_same_shape_ms" in row else {}),
        **({"cublas_products_ms": row["cublas_products_ms"]}
           if "cublas_products_ms" in row else {}),
        # K6f: the model's unfused float layer (cuDNN convolutions and
        # PyTorch elementwise passes), for context only.
        **({"production_layer_ms": row["production_layer_ms"]}
           if "production_layer_ms" in row else {}),
        # K2b: the inline route (the grid quantized in the call), as the
        # model ran it before the grids were quantized once per video.
        **({"inline_route_ms": row["inline_route_ms"]}
           if "inline_route_ms" in row else {}),
    ))
  print(card)
  emit({"kernels": kernels})
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  if sys.argv[1:2] == ["--records"] and len(sys.argv) == 3:
    RECORDS = sys.argv[2]
  elif sys.argv[1:]:
    sys.exit("usage: python3 chip_smoke.py [--records PATH]")
  main()
