"""Smoke run of the PyTorch/CUDA port (mgsv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA device

Drives the port's two paths at the paper widths (Config(): D=256, 50
frames, 96 snippets, 2 DETR encoder / 6 decoder layers, B=512 in training)
with seeded random weights, in phases that each print lines and raise on
failure:

  1. device   card name, and its name and power limit from nvidia-smi
  2. build    compiles the CUDA kernels from mgsv_tpu_torch/csrc, one nvcc
              per source, all started together; registers and spills; then
              the native gather (runtime/mgsv_io.cc) with g++, timed
  3. kernels  each kernel against its plain PyTorch version on the card
              (float32, TF32 off) at the training shapes, at rate 0 and at
              the configuration's dropout rate: the forward output and every
              gradient; kernel and plain times in turns; the encoder layer
              also at the serving shapes, timed beside its bound, and at
              precision "bf16" (the bf16 Config()'s: bf16 operands, float32
              sums) against its bf16 plain version, forward and every
              gradient, timed in turns with the float32 instantiation
              beside the bf16 bound; the encoder layer's forward (#1) and
              backward (#2) at both precisions and #3's backward and
              forward also by kernel name (one call under torch.profiler,
              [breakdown] lines: the forward's u^T launch, the tf32 splits
              and the pair kernel), with the forward's workspace bytes
  4. temporal-kernel  the temporal-tower layer's kernels (#5, forward and
              backward) against their plain version at B=512 for the audio
              (L=96) and video (L=50) towers, rates 0 and 0.8, a row with no
              valid key included; the training forward's saved activations
              against their plain version, and the backward given them
              equal to the recomputing one bit for bit, two calls
              bit-identical, and held against the plain backward from the
              saved set, at both towers and at two ragged small shapes;
              kernel and plain times in turns beside the bound (the
              backward given the saved set, as a step runs it), and by
              kernel name ([breakdown]: the forwards, and the backward
              given the saved set and recomputing); the forward also at the
              evaluation's B=40, rate 0
  5. decoder-kernel  the DETR decoder layer's kernels (#6, forward and
              backward) against their plain version at B=512, L=152 for
              Q=1 and Q=10 queries, self-attention on, ragged key masks with
              a row of one valid key; the training forward's saved set
              against its float64 plain version, and the backward given it
              (what autograd runs, and what is timed) equal to the bit to
              the backward given the forward's memory k|v alone and to two
              recomputing calls; kernel and plain times in turns beside the
              bound, the training forward's and the other backwards' times,
              [breakdown] lines with their launch counts; the forward also
              at the evaluation's B=40, Q=1
  6. train    one float32 training step of MaDe (Config() widths, dropout
              on) through the kernels and one through the plain versions,
              from the same weights, batch and seed: the loss and every
              parameter's gradient compared (the plain steps take the
              kernel step's gates where a ReLU outside the kernels lies
              within rounding of zero); launches per step, the step's
              device operations and peak memory read; then
              the same for Config(fused_temporal=True) (temporal-train) and
              for ten moment queries with fused_decoder=True (train-q: the
              decoder on #6, detr_dropout 0, every LSAP solve of the step
              held against SciPy); with detr_dropout 0.1 that step raises
  7. timed    a few steps of the default bf16 Config() at B=512, of the
              same with fused_temporal, and of ten moment queries with and
              without fused_decoder, in turns: clips/s and peak memory
  8. slice    serving: a 4,096-track index built through build_music_index,
              queries at B=1 and B=32 through RetrievalEngine with the
              kernel, held against the same engine without it; launches read
  9. http     RetrievalServer on 127.0.0.1: /healthz and three /query
              replies equal to direct engine.query calls
 10. eval-kernel  the evaluation X-Pool kernel (#4) against its plain
              version at V = M = 2,048, S = 96 (the corpus of an MGSV-EC
              split), timed in turns beside its bound, its workspace bytes
              and a [breakdown] by kernel name; one line at the serving
              scan's shape (V = 32, M = 4,096) for information
 11. train-cli  `cli.train` in-process on 2,048 generated rows of the
              default bf16 Config(): 4 steps at B=512, then an evaluation
              at B=40 (52 batches, one corpus similarity), the data resident
              on the card through train.device_data "auto" (no host
              pipeline call); history.json, the best_* and last checkpoints
              and every launch count read
 12. native-io  the native gather against the numpy memmap gather on those
              rows, a B=512 batch's store rows and every row, float32 and
              raw, bit for bit; ms per B=512 host batch both ways, in turns
 13. device-data  DeviceResidentData of those rows: bytes uploaded, every
              resident batch of a B=512 epoch and a B=40 evaluation pass
              torch.equal to the host pipeline's; ms per batch of the device
              gather (CUDA events) and of the host pipeline
 14. train-cli-host  `cli.train --train.device_data off` on the same rows:
              the resident run's record and last weights, bit for bit
 15. train-cli-fused  `cli.train --model.fused_temporal true` on the same
              rows: 4 steps and one evaluation, #5's launches per step and
              per evaluation read
 16. train-accum  `cli.train --train.gradient_accumulation_steps 2`: 4
              micro-batches, 2 updates, weights equal bit for bit to an
              independent accumulation (the port's forward and backward per
              micro-batch, the gradients' running mean, a k = 1 update per
              two); preempted at micro-step 3 and resumed, equal to the
              uninterrupted run; peak memory
 17. evaluate-cli  `cli.evaluate` on that run's best_r1 checkpoint: its
              metrics equal the trainer's record; then `evaluate` with the
              kernel and with the plain corpus similarity on the same
              weights, timed: similarities, localization and ranks compared;
              then resident and from the host in turns: ranks, IoUs and
              spans equal, no host sync in the resident pass, wall times
              and each path's device busy share under torch.profiler
 18. eval-q   `evaluate` of the same rows at ten moment queries (float32),
              with the decoder on #6 and without: the same ranks, moments
              within 1e-4 of max_m_duration, six #6 launches per batch
 19. variants  the variant matrix: #1/#2 at the CA fusion's L=96 (both
              precisions, against the plain version and float64, timed beside
              the bound) and #5 as a shared stack runs it (one layer's weights
              on the audio then the video rows, the weights' gradients summed
              over both calls); then for each branch (pre-norm; vmr_loss dual,
              single, sim_fuse, feature_fuse, oneloss, and dual without X-Pool;
              XA-video and XA-music-video; CA with and without fused_decoder;
              the music, xpool and zero decoder queries; regression with and
              without predict_center; the moment head with and without
              audio_short_cut; the shared stack, plain and on #5; B=512 for
              CA, XA-music-video, pre-norm and the fused shared stack, B=64
              for the rest) one float32 step through the kernels against the
              plain steps (float32 and float64, given the kernel step's gates
              where a ReLU outside the kernels lies within rounding of zero:
              loss and every gradient, the launches each branch must show),
              then bf16 steps (finite loss, step ms, peak memory);
              `cli.train` for 2 steps and one evaluation, and `cli.evaluate`
              equal to its record, with CA and with pre-norm; a pre-norm RetrievalEngine on the card (no
              encoder-layer kernel) against the plain engine, and the refusal
              of a CA model by the engine; the phase's seconds
 20. agg-cls  the EmbeddingNet aggregator and the cls token: #5 at the cls
              token's lengths, L=97 and L=51 (B=512, rate 0.8, forward and
              backward against the plain version and float64, the saved set
              and the backward given it, timed in turns beside the bound);
              then for each branch (mlp, cls, mlp with cls, cls with
              fused_temporal; B=512) one float32 step through the kernels
              against the plain steps (loss, every gradient, the launches,
              the EmbeddingNets' running buffers, the lengths each tower's
              aggregator sees), and bf16 steps of each and of the default
              Config() in turns (step ms, peak memory); `cli.train` for 2
              steps and one evaluation with the EmbeddingNet and with the cls
              token, `cli.evaluate` equal to each record, the EmbeddingNet
              checkpoint's buffers moved and `cli.index build` on it refused;
              `cli.index build` and `query --run-dir --ckpt last` of the cls
              run, equal to build_music_index and RetrievalEngine.query, and
              that checkpoint in a float32 engine on #1 against the plain
              engine at B=1 and B=32
 21. flash-kernel  the attention kernel (#7) against its plain version in
              float32 and bf16: the AST's [96, 12, 1214, 64] (one track),
              [8, 12, 1214, 64] with ragged key masks and a fully masked
              row, CLIP's [400, 12, 50, 64], and the extraction's
              [384, 12, 1214, 64]; kernel, plain and SDPA timed in turns
              beside the bound; [breakdown] lines of the extraction's shape
              (float32) and of one track (bf16)
 22. extract  `cli.extract_features` in-process on seeded raw media (8 frame
              directories of 10-50 JPEGs, WAV tracks of 240/180/60/30 s, one
              at 44.1 kHz) with full-width CLIP ViT-B/32 and AST checkpoints
              minted in the reference layouts: store ids, shapes and masks,
              12 kernel launches per music chunk, one video batch and one
              track encoded again with the plain towers; videos/s, tracks/s,
              host and device seconds

 23. ddp    data parallelism, 2 ranks on the one card over gloo (CUDA
              tensors; NCCL refuses two ranks on one device), each a process
              of this script (`--ddp-rank`), at Config() in float32 with a
              global B=512, 256 rows a rank: one step at every dropout rate 0
              from the [train] step's weights and batch, its loss and every
              synchronized gradient held as [train] holds the kernel step
              (against the plain and float64 one-process steps, which take
              the one-process kernel step's gates; each rank takes its rows'
              share of those gates), bit-identical gradients on both ranks,
              each rank's #1/#2/#3 launches, timed steps beside the
              one-process step, the gradient sync's ms and bytes, the
              split tables' batch assembly at B=512 and 40; one step
              at the configured rates from fresh weights, bit-identical
              weights on both ranks; `evaluate` of 2,048 generated rows,
              resident and split over the ranks, with #4 split over the
              tracks: its similarity within 1e-4 of the one-process #4's,
              the same ranks off near ties; a world of one over NCCL equal
              to the step without a group bit for bit (loss, gradients,
              weights); `cli.train --coordinator` on 2 ranks, 1 epoch of
              2,048 rows at dropout 0 in float32 (data resident and split),
              MP_RESULT lines equal, records equal to one process's, and
              `cli.evaluate` on 2 ranks equal to one process's
 24. model-axis  the model axis over gloo on the one card, each rank a
              process of this script (`--model-axis-rank`): the engine with
              the 4,096-track index sharded over 2 ranks (dp), at B=1 and
              32, top_k 5, against the one-process engine (same ids off
              near ties, moments 5e-3 s, scores 1e-4), #1's launches and
              the pairs each rank localized, query p50 per rank beside the
              one process's; then 4 ranks at (2, 2), Config() in float32,
              B=512: [ddp]'s held step (its gates, against the one-process
              and float64 steps), the 4 ranks' gradients and weights after
              a step at the rates bit-identical, and `evaluate` of [ddp]'s
              2,048 rows with the plain 2-D similarity and with #4 split
              over dp, each within 1e-4 of one process's, ranks moved only
              at near ties
 25. ab     the trained-behaviour A/B of scripts/ab_kernels_cuda.py at
              the paper widths, its kernel arms (Config() on #1/#2/#3, and
              with fused_temporal on #5 too) against the plain arm: the
              dropout fingerprint at AB_DRAWS mask draws a scenario (one
              64-row batch, float32; the "none" control within its bound,
              Holm clean over each arm's means and spreads), then the
              dropout-off check (float32, rate 0, bs 32): 24 steps of each
              kernel arm from the plain arm's weights and optimizer state,
              loss and gradient norm within their bounds, and the
              free-running trajectories beside a one-ulp control; each
              arm's launches of #1, #2, #3 and #5
 26. jax-resume  a run of the JAX package's Trainer carried into the port
              (tests/fixtures/jax_run: D=256, every other width small,
              float32, dropout off, preempted mid-epoch by JAX and converted
              by scripts/convert_jax_run.py) resumed by `cli.train --device
              cuda --train.resume last` on the kernels (#1/#2/#3 in each
              step, #4 in each evaluation): every resumed step's loss and
              each continued history record within 1e-4 of JAX's own
              resumed run, recorded beside the fixture; the launches

Every line ends in at_s, the seconds since the script started.  Then it
prints the kernels' JSON line and, last, {"ok": true, "device": ...}.
It exits non-zero, without that last line, when no CUDA device is present
or any phase fails.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import http.client
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np
import torch

import torch.nn.functional as F

from mgsv_tpu_torch.cli import evaluate as evaluate_cli
from mgsv_tpu_torch.cli import extract_features as extract_cli
from mgsv_tpu_torch.cli import index as index_cli
from mgsv_tpu_torch.cli import train as train_cli
from mgsv_tpu_torch.cli.overrides import overrides_to_args
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core import dist
from mgsv_tpu_torch.core.checkpoint import CheckpointManager, load_weights
from mgsv_tpu_torch.core.flops import peak_tflops, train_step_flops
from mgsv_tpu_torch.core.device import resolve_device
from mgsv_tpu_torch.core.mesh import local_rows, make_mesh, sync_gradients
from mgsv_tpu_torch.data import synthetic_raw
from mgsv_tpu_torch.data.audio import extract_snippets, resample_sinc
from mgsv_tpu_torch.data.dataset import MgsvDataset, epoch_index_batches
from mgsv_tpu_torch.data.device_data import (DeviceResidentData, dataset_device_bytes,
                                             gather_batch)
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.data.feature_store import PackedFeatureStore
from mgsv_tpu_torch.data.frames import load_clip_frames
from mgsv_tpu_torch.data.media import load_wav
from mgsv_tpu_torch.data.pipeline import prefetch_epoch
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.synthetic import open_synthetic
from mgsv_tpu_torch.eval.evaluator import evaluate
from mgsv_tpu_torch.eval.similarity import (xpool_eval_inputs, xpool_sim_fused,
                                            xpool_similarity_blocked, xpool_similarity_mesh)
from mgsv_tpu_torch.models.detr import DetrDecoderLayer, DetrEncoderLayer
from mgsv_tpu_torch.models.layers import l2_normalize
from mgsv_tpu_torch.models.made import MaDe, uses_fused_sim
from mgsv_tpu_torch.models.temporal import TemporalTransformer
from mgsv_tpu_torch.models.xpool import XPoolTransformer
from mgsv_tpu_torch.ops import lsap, philox
from mgsv_tpu_torch.ops.cuda import flash_attention as fa
from mgsv_tpu_torch.ops.cuda import fused_decoder_layer as fdl
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
from mgsv_tpu_torch.ops.cuda import fused_temporal_layer as ftl
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps
from mgsv_tpu_torch.runtime import kernels, native
from mgsv_tpu_torch.serve.engine import MusicIndex, RetrievalEngine, build_music_index
from mgsv_tpu_torch.train import loop as train_loop
from mgsv_tpu_torch.train.loop import Preempted
from mgsv_tpu_torch.train.objective import total_loss
from mgsv_tpu_torch.train.optimizer import GroupedAdam, make_optimizer
from mgsv_tpu_torch.train.step import make_eval_step, make_train_step, step_generator

STARTED = time.perf_counter()
SEED = 0
DROPOUT_SEED = 1234        # the Philox seed of the kernel phases
TRAIN_B = 512              # the paper's training batch
TRAIN_L = 152              # 50 frames + 96 snippets, padded to a multiple of 8
N_TRACKS = 4096            # MGSV-EC's catalog size
EVAL_N = 2048              # corpus of the eval phases: about an MGSV-EC split (2,000)
SERVE_V = 32               # videos of a B=32 serving scan over the N_TRACKS index
SERVE_ROWS = (8, 256)      # fused rows B*k: a B=1 query, and B=32 x k-bucket 8
TIMED_STEPS = 5
GATHER_TURNS = 6           # host gathers of a B=512 batch, native and numpy in turns
EVAL_TURNS = 3             # evaluations of the EVAL_N rows, resident and host in turns
ACCUM_K = 2                # gradient accumulation of the train-accum phase
Q_MULTI = 10               # moment queries of the multi-query phases
HORIZON = 1000             # schedule length the optimizers are built for
VARIANT_B = 64             # batch of the variant branches that do not train at B=512
VARIANT_N = 1024           # rows of the variant CLI runs: 2 steps at B=512
VARIANT_TRACKS = 512       # index of the pre-norm engine
# The variant matrix: (branch, model overrides, loss overrides, batch,
# fused_decoder).  CA, XA-music-video, pre-norm and the shared fused stack
# train at B=512, the rest at VARIANT_B.
BRANCHES = [
    ("pre_norm", dict(detr_pre_norm=True), {}, TRAIN_B, False),
    ("dual", {}, dict(vmr_loss="dual"), VARIANT_B, False),
    ("single", {}, dict(vmr_loss="single"), VARIANT_B, False),
    ("sim_fuse", {}, dict(vmr_loss="dual_single_sim_fuse"), VARIANT_B, False),
    ("feature_fuse", {}, dict(vmr_loss="dual_single_feature_fuse"), VARIANT_B, False),
    ("oneloss", dict(vmr_fusion="XA-music-video"), dict(vmr_loss="dual_single_oneloss"),
     VARIANT_B, False),
    ("no_xpool_dual", dict(vmr_fusion="NO"), dict(vmr_loss="dual"), VARIANT_B, False),
    ("xa_video", dict(vmr_fusion="XA-video"), dict(vmr_loss="single"), VARIANT_B, False),
    ("xa_music_video", dict(vmr_fusion="XA-music-video"), dict(vmr_loss="single"), TRAIN_B,
     False),
    ("ca", dict(mml_fusion="CA"), {}, TRAIN_B, False),
    ("ca_fused_decoder", dict(mml_fusion="CA", detr_dropout=0.0), {}, TRAIN_B, True),
    ("query_music", dict(moment_query_type="music"), {}, VARIANT_B, False),
    ("query_xpool", dict(moment_query_type="xpool"), {}, VARIANT_B, False),
    ("query_zero", dict(moment_query_type="zero"), {}, VARIANT_B, False),
    ("regression", dict(mml_localization="regression"), {}, VARIANT_B, False),
    ("regression_center", dict(mml_localization="regression", predict_center=True), {},
     VARIANT_B, False),
    ("moment_head", dict(moment_loss=True), {}, VARIANT_B, False),
    ("moment_head_short_cut", dict(moment_loss=True, audio_short_cut=True), {}, VARIANT_B,
     False),
    ("shared", dict(transformer_is_share=True), {}, VARIANT_B, False),
    ("shared_fused_temporal", dict(transformer_is_share=True, fused_temporal=True), {},
     TRAIN_B, False),
]
# The aggregators and the cls token (the agg-cls phase): (branch, model
# overrides), each at B=512.
AGG_BRANCHES = [
    ("mlp", dict(agg_module="mlp")),
    ("cls", dict(with_cls_token=True)),
    ("mlp_cls", dict(agg_module="mlp", with_cls_token=True)),
    ("cls_fused_temporal", dict(with_cls_token=True, fused_temporal=True)),
]
AGG_TIMED_STEPS = 3        # bf16 steps a turn, each branch and the default in turns
# H100 SXM peaks (NVIDIA's data sheet, dense): the kernels compute float32
# on the tensor cores as TF32 products, so their bound takes the TF32 rate.
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# The attention kernel (#7) at the frozen towers' shapes: the AST's 1,214
# tokens (12 x 101 patches + cls + dist), 12 heads of 64; one track is 96
# snippets; the extract phase runs the CLI at --batch 32, so each AST
# forward takes 4 tracks (384 snippets).  CLIP ViT-B/32: 50 tokens per frame.
AST_TOKENS, AST_HEADS, HEAD_DIM = 1214, 12, 64
SNIPPETS = 96
EXTRACT_BATCH = 32
CLIP_TOKENS = 50
# bf16 kernel vs the float32 plain version: q and p are rounded to bf16
# (8 significant bits) before the products, outputs are means of N(0, 1)
# values of order 1.  The encoder layer at precision "bf16" against its bf16
# plain version: both round the same operands, but one float32 rounding
# step apart can put an operand on the other side of a bf16 rounding
# boundary, and that moves a product by 2^-8 of itself; outputs of order 1
# after LayerNorm.
BF16_ATOL = 2e-2
# Its gradients, as GRAD_RTOL below but with 1e-2 of each tensor's largest
# magnitude: the same flips, summed over 77,824 rows.
BF16_GRAD_RTOL = 1e-2

# Tolerances of a kernel against its plain version (both float32, TF32 off).
# Forward outputs: the kernels' GEMMs keep float32 accuracy (3xTF32 on the
# tensor cores, each tile's partial sum added in float32), so kernel and
# plain version differ by rounding and summation order; both layers end in
# LayerNorm (and X-Pool in a cosine), so outputs are of order 1 and move by
# a few 1e-6.  1e-4 leaves more than an order of headroom and still catches
# an indexing, masking or dropout fault, which moves outputs by O(1e-2..1).
KERNEL_ATOL = 1e-4
# Gradients are held against a float64 run of the plain version.  They are
# sums over up to 77,824 rows (B*L) or 262,144 pairs, and a float32 ReLU
# gate flips wherever its input lies within rounding of zero (tens of the
# 80M gates of an encoder layer at B=512): each flip moves a gradient by a
# whole O(1) term, so two float32 versions disagree by far more than
# rounding.  Per tensor the kernel's max abs error against float64 must stay
# within 1e-3 x the largest magnitude of the gradient, plus twice the error
# the float32 plain version itself makes there, plus 1e-6 for gradients
# that are zero in exact arithmetic (key biases: a softmax ignores a
# constant shift).  A wrong index or mask moves a gradient by O(its size).
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-6
# The decoder layer at B=512 has 0.5M (Q=1) to 5M (Q=10) FFN gates, few
# enough that the float32 plain run may happen to flip none while the
# kernel flips one, and twice the plain run's error then covers nothing.
# A float32 pre-activation (order 1, 256 products at float32 accuracy) is
# off by well under FLIP_EPS, so only a gate whose float64 pre-activation
# lies within FLIP_EPS of zero can fall the other way: the decoder's
# gradients are allowed, element by element, the sum of what flipping each
# of those gates does to the float64 run (gate_flip_slack).
FLIP_EPS = 1e-5
# The training loss: InfoNCE over 512 x 512 logits scaled by 1/0.03 and the
# set criterion; against float64 within 1e-4 relative plus twice the float32
# plain step's own error.
LOSS_RTOL = 1e-4
SPAN_ATOL_S = 5e-3         # localized moments, seconds on a 240 s scale
SCORE_ATOL = 1e-4

# Fused and plain corpus similarities on the same weights: their ranks may
# differ only in rows where another track's similarity lies this close to
# the GT's (twice KERNEL_ATOL: each side may move by up to it).
RANK_TIE_ATOL = 2e-4
MIOU_ATOL = 1e-6           # the evaluation CLI's mIoU against the trainer's record
DDP_RANKS = 2              # ranks of the ddp phase, on the one card
DDP_TIMED_STEPS = 3        # float32 steps timed on each rank and in one process
SYNC_REPS = 3              # timed gradient syncs a rank
DDP_RANK_TIMEOUT = 600     # seconds a rank job may take
# the 2-rank cli.train's and cli.evaluate's records against one process's
# (float32, dropout 0; one epoch of 4 steps): the losses agree to float32
# rounding of sums taken in another order, the retrieval metrics to a rank
# or two of 2,048 rows (the ranks' batches of 20 rows round otherwise than
# one process's 40 near a tie)
DDP_LOSS_RTOL = 1e-4
DDP_RECALL_ATOL = 0.1
DDP_MIOU_ATOL = 1e-3
MA_ENGINE_RANKS = 2        # the model-axis phase's engine: the index over 2 ranks (dp)
MA_MESH_SHAPE = (2, 2)     # its step and evaluation: dp x mp ranks on the one card
MA_MESH_RANKS = MA_MESH_SHAPE[0] * MA_MESH_SHAPE[1]
MA_QUERY_REPS = 6          # timed queries a batch, for the p50
MA_SIM_REPS = 3            # timed 2-D similarities of EVAL_N x EVAL_N a rank
AB_DRAWS = 16              # mask draws a scenario of the [ab] fingerprint
JAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "jax_run")
JAX_RESUME_RTOL = 1e-4     # the resumed losses on the kernels against JAX's on the CPU

COUNTERS = {"fused_encoder_layer": fel.fused_encoder_layer,
            "fused_encoder_layer_bwd": fel.fused_encoder_layer_bwd,
            "xpool_sim_fwd": xps.xpool_sim_fwd,
            "xpool_sim_bwd": xps.xpool_sim_bwd,
            "xpool_sim_eval": xps.xpool_sim_eval,
            "flash_attention": fa.flash_attention,
            "fused_temporal_layer": ftl.fused_temporal_layer,
            "fused_temporal_layer_bwd": ftl.fused_temporal_layer_bwd,
            "fused_decoder_layer": fdl.fused_decoder_layer,
            "fused_decoder_layer_bwd": fdl.fused_decoder_layer_bwd}
EVAL_B = Config().train.batch_size_val     # the paper's evaluation batch (40)


def per_step(cfg: Config, fused_decoder: bool = False) -> dict:
    """Launches of one training step: the post-norm encoder layers (none
    in pre-norm, as JAX's), the X-Pool similarity where the configuration
    takes it from the kernel (`uses_fused_sim`), with fused_temporal each
    tower's temporal layers (a shared stack's too: one call per tower; none
    without the temporal aggregator), and
    with fused_decoder each decoder layer."""
    m = cfg.model
    enc = m.detr_enc_layers if m.fused_detr_encoder and not m.detr_pre_norm else 0
    sim = int(uses_fused_sim(cfg))
    temporal = 2 * m.temporal_depth if m.fused_temporal and m.agg_module == "transf" else 0
    decoder = m.detr_dec_layers if fused_decoder else 0
    return {"fused_encoder_layer": enc, "fused_encoder_layer_bwd": enc,
            "xpool_sim_fwd": sim, "xpool_sim_bwd": sim, "xpool_sim_eval": 0,
            "flash_attention": 0, "fused_temporal_layer": temporal,
            "fused_temporal_layer_bwd": temporal, "fused_decoder_layer": decoder,
            "fused_decoder_layer_bwd": decoder}


def phase(tag: str, /, **fields) -> None:
    fields["at_s"] = f"{time.perf_counter() - STARTED:.1f}"
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


@contextlib.contextmanager
def plain_kernels():
    """The training step's kernel wrappers replaced by their plain versions
    (the model looks them up at each call), so a step runs autograd through
    the plain versions on the card."""
    with mock.patch.object(fel, "fused_encoder_layer", fel.fused_encoder_layer_reference), \
            mock.patch.object(xps, "xpool_sim", xps.xpool_sim_reference), \
            mock.patch.object(ftl, "fused_temporal_layer", ftl.fused_temporal_layer_reference), \
            mock.patch.object(fdl, "fused_decoder_layer", fdl.fused_decoder_layer_reference):
        yield


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def cuda_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, plain, iters: int = 5):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain after one
    warm-up call each, so drift hits both alike."""
    cuda_ms(kernel, 1)
    cuda_ms(plain, 1)
    p1, k1, k2, p2 = (cuda_ms(fn, iters) for fn in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def breakdown(name: str, fn, **fields) -> None:
    """One call of fn under torch.profiler, after a warm-up call that the
    profiler runs but does not keep (without it, the profiler can miss the
    first launches of the call): its device time summed by kernel name,
    one [breakdown] line per kernel (ms, launches), largest first, beside
    the call's time from CUDA events; where the profiler saw no device
    time, one line per kernel wrapper the call launched.  The first line
    counts the kernel names and their launches."""
    fn()
    torch.cuda.synchronize()
    events_ms = cuda_ms(fn, 1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    kept = []                  # the recorded step's events, kept as it ends
    with torch.profiler.profile(activities=acts,
                                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                                on_trace_ready=lambda p: kept.append(p.key_averages())) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # the kernels' own device time: a host op (an autograd Function, the
    # profiler's own buffer requests, the schedule's step) carries its
    # children's as well
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in kept[0]
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("ProfilerStep")), key=lambda r: -r[1])
    if not rows:
        before = read_counts()
        fn()
        rows = [(f"{kernel} (CUDA events, the whole call)", events_ms, count - before[kernel])
                for kernel, count in read_counts().items() if count != before[kernel]]
    phase("breakdown", name=name, **fields, device_ms=f"{sum(r[1] for r in rows):.4f}",
          events_ms=f"{events_ms:.4f}", kernels=len(rows), launches=sum(r[2] for r in rows))
    for kernel, ms, count in rows:
        print(f"[breakdown]   {ms:9.4f} ms {count:4d} x {kernel[:120]}", flush=True)


def bound(flops: float, nbytes: int, peak_flops: float = PEAK_TF32_FLOPS) -> tuple:
    """(ms, "operations" | "bytes"): the larger of the operations at the
    peak rate of their type (TF32 for the float32 kernels) and the bytes
    (inputs read once, outputs written once) at the memory rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def entry(name, source, replaces, err, ms, plain_ms, flops, nbytes,
          library_ms=None) -> dict:
    """One kernel's record.  No single PyTorch call computes the encoder
    layer (it adds pos to q and k only, and runs both LayerNorms and the FFN
    after the attention), the decoder layer (pos and query_pos enter q and k
    only, so nn.TransformerDecoderLayer does not apply), the temporal layer
    (nn.TransformerEncoderLayer with norm_first adds each residual to x, not
    to LN(x)) or the X-Pool pair stage (a softmax pooling followed by two
    LayerNorms, a dropped branch and a cosine per pair), so their library_ms
    is null; the attention kernel's is SDPA's."""
    bound_ms, bound_by = bound(flops, nbytes)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def encoder_flops(b: int, length: int, d: int, ffn: int) -> int:
    """One encoder layer's forward: QKV, scores and P.V, out-projection, FFN."""
    rows = b * length
    return (2 * rows * d * 3 * d + 4 * b * length * length * d + 2 * rows * d * d
            + 4 * rows * d * ffn)


def decoder_flops(b: int, q: int, length: int, d: int, ffn: int) -> int:
    """One decoder layer's forward with self-attention: the cross-attention's
    k and v of the B*L memory rows (the same at any Q), the self-attention's
    QKV, scores, P.V and out-projection over the Q queries, the
    cross-attention's q, scores and P.V over L keys and out-projection, FFN."""
    rows, mem = b * q, b * length
    return (2 * mem * d * 2 * d + 2 * rows * d * 3 * d + 4 * b * q * q * d + 2 * rows * d * d
            + 2 * rows * d * d + 4 * b * q * length * d + 2 * rows * d * d + 4 * rows * d * ffn)


def temporal_flops(b: int, length: int, d: int, ffn: int) -> int:
    """One temporal layer's forward per batch row: QKV and out-projection
    (8 L D^2), scores and P.V (4 L^2 D), FFN (4 L D F)."""
    return b * (8 * length * d * d + 4 * length * length * d + 4 * length * d * ffn)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ragged_mask(rng: np.random.Generator, rows: int, length: int, lo: int) -> np.ndarray:
    lens = rng.integers(lo, length + 1, rows)
    return (np.arange(length)[None] < lens[:, None]).astype(np.float32)


def randn(rng: np.random.Generator, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)


@torch.no_grad()
def perturb_(module: torch.nn.Module, generator: torch.Generator, scale: float = 0.02):
    """Move every parameter off its initial value (identity projections,
    zero biases, unit LayerNorms), so every gradient path carries signal."""
    for p in module.parameters():
        p.add_(scale * torch.randn(p.shape, generator=generator))
    return module


def check_close(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error of a forward output against the plain version's."""
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or not err <= KERNEL_ATOL:
        raise AssertionError(f"{what}: max abs error {err} > {KERNEL_ATOL}")
    return err


def check_grads(what: str, names, kernel, plain, exact, rtol: float = GRAD_RTOL,
                slack=None) -> tuple:
    """The kernel's gradients against the float64 plain run `exact`, with
    the float32 plain run's error as the allowance (see GRAD_RTOL; `rtol`
    in its place) and, per element, `slack` (one tensor per gradient, see
    FLIP_EPS) when given; returns
    (the kernel's largest max abs error, the float32 plain run's largest,
    the name of the tensor where the kernel's is largest, that tensor's
    largest magnitude)."""
    worst, worst_plain, worst_name, worst_max = 0.0, 0.0, "", 0.0
    for i, (name, k, p, e) in enumerate(zip(names, kernel, plain, exact)):
        diff = (k.double() - e).abs()
        err, plain_err = diff.max().item(), (p.double() - e).abs().max().item()
        tol = rtol * e.abs().max().item() + 2 * plain_err + GRAD_FLOOR
        beyond = err if slack is None else (diff - slack[i]).max().item()
        if not torch.isfinite(k).all() or not beyond <= tol:
            raise AssertionError(f"{what} d{name}: max abs error {err} ({beyond} beyond the "
                                 f"gate-flip slack) > {tol}")
        if err >= worst:
            worst, worst_name, worst_max = err, name, e.abs().max().item()
        worst_plain = max(worst_plain, plain_err)
    return worst, worst_plain, worst_name, worst_max


def check_device() -> tuple:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    phase("device", name=json.dumps(name), count=torch.cuda.device_count())
    print(smi.splitlines()[0], flush=True)
    return name, smi.splitlines()[0]


def build_kernels() -> None:
    t0 = time.perf_counter()
    kernels.build_all()
    for name in kernels.KERNELS:
        log = kernels.build_logs.get(name, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
        phase("build", kernel=name, max_registers=max(regs, default="cached"),
              spill_store_bytes=sum(spills))
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}")


def build_native() -> str:
    """Compile the native gather (runtime/mgsv_io.cc) with g++ before any
    store opens; returns its build seconds as printed."""
    cached = os.path.exists(native.library_path())
    t0 = time.perf_counter()
    native.get_lib()
    seconds = f"{time.perf_counter() - t0:.2f}"
    phase("build", native="libmgsv_io", compiler="g++", cached=cached, seconds=seconds)
    return seconds


def encoder_flip_slack(layer64, x, mask, pos, g, rate: float, seed: int) -> tuple:
    """gate_flip_slack for an encoder layer at B=512, where one full-batch
    float64 backward per gate would take minutes: a gate of batch row b
    moves only row b's dx and dpos and row b's share of the weight
    gradients, so each gate within FLIP_EPS of zero is flipped in a float64
    run of row b alone (its Philox masks sliced from the batch's).  Returns
    (per gradient of [x, pos, *parameters] the summed |effect| of flipping
    each such gate, the number of such gates)."""
    b_all, length, d = x.shape
    heads, ffn = layer64.self_attn.heads, layer64.linear1.out_features
    masks = (philox.encoder_masks(seed, b_all, length, d, ffn, heads, rate, device=x.device)
             if rate > 0.0 else None)
    x, mask, pos, g = (t.double() for t in (x, mask, pos, g))
    seen = {}
    hook = layer64.linear1.register_forward_hook(lambda m, i, o: seen.update(z=o.detach()))
    with torch.no_grad():
        fel.fused_encoder_layer_reference(x, mask, pos, layer64, rate, seed)
    hook.remove()
    near = torch.nonzero(seen.pop("z").abs() < FLIP_EPS)
    params = list(layer64.parameters())
    slack = [torch.zeros_like(x), torch.zeros_like(pos)] + [torch.zeros_like(p) for p in params]

    def row_grads(b, flip=None):
        row = slice(b, b + 1)
        xi, pi = x[row].clone().requires_grad_(), pos[row].clone().requires_grad_()
        hook = None if flip is None else layer64.linear1.register_forward_hook(
            lambda m, i, o: torch.where(flip, o - 2 * o.detach(), o))
        row_masks = None if masks is None else {k: v[row].double() for k, v in masks.items()}
        out = layer64(xi, mask[row], pi, row_masks)
        if hook is not None:
            hook.remove()
        return torch.autograd.grad(out, [xi, pi, *params], g[row])

    for b in near[:, 0].unique().tolist():
        base = row_grads(b)
        for _, l, j in near[near[:, 0] == b].tolist():
            flip = torch.zeros(1, length, ffn, dtype=torch.bool, device=x.device)
            flip[0, l, j] = True
            for i, (a, c) in enumerate(zip(row_grads(b, flip), base)):
                (slack[i][b:b + 1] if i < 2 else slack[i]).add_((a - c).abs())
    return slack, len(near)


def check_encoder(device: torch.device, length: int = TRAIN_L) -> list:
    """Kernels #1 (forward) and #2 (backward) against autograd through the
    plain version, at B=512, L=152 (or `length`: the CA fusion's 96
    snippet rows), rates 0 and the configuration's; then both at precision
    "bf16" (check_encoder_bf16).  At L=152 also the serving shapes and the
    [breakdown] lines; at another length the entries are named
    "<kernel>@L<length>", and the float32 gradients are also allowed the
    float64 effect of the ReLU gates within FLIP_EPS of zero
    (encoder_flip_slack): at L=96 the kernel and the float32 plain version
    flip different gates, and one flip moves dx by up to 0.2 on an H100."""
    full = length == TRAIN_L
    m = Config().model
    d, heads, ffn, rate = m.dim_input, m.detr_heads, m.detr_ffn_dim, m.detr_dropout
    gen = torch.Generator().manual_seed(SEED)
    layer = DetrEncoderLayer(d, heads, ffn)
    layer.reset_parameters(gen)
    layer = perturb_(layer, gen).to(device)
    params = list(layer.parameters())
    names = ["x", "pos"] + [n for n, _ in layer.named_parameters()]
    rng = np.random.default_rng(SEED)
    x, pos, g = (randn(rng, (TRAIN_B, length, d), device) for _ in range(3))
    mask = torch.from_numpy(ragged_mask(rng, TRAIN_B, length, 1)).to(device)
    layer64 = copy.deepcopy(layer).double()
    fwd_err = bwd_err = 0.0
    for r in (0.0, rate):
        outs, grads = {}, {}
        for kind, fn, lay, dt in (("kernel", fel.fused_encoder_layer, layer, torch.float32),
                                  ("plain", fel.fused_encoder_layer_reference, layer,
                                   torch.float32),
                                  ("exact", fel.fused_encoder_layer_reference, layer64,
                                   torch.float64)):
            xi, pi = (t.detach().to(dt).requires_grad_() for t in (x, pos))
            out = fn(xi, mask.to(dt), pi, lay, r, DROPOUT_SEED)
            grads[kind] = torch.autograd.grad(out, [xi, pi, *lay.parameters()], g.to(dt))
            outs[kind] = out.detach()
            del out
        torch.cuda.synchronize()
        err = check_close(f"fused_encoder_layer rate {r}", outs["kernel"], outs["plain"])
        slack, flips = (None, None) if full else encoder_flip_slack(layer64, x, mask, pos, g,
                                                                     r, DROPOUT_SEED)
        gerr, perr, gname, gmax = check_grads(f"fused_encoder_layer_bwd rate {r}", names,
                                              grads["kernel"], grads["plain"], grads["exact"],
                                              slack=slack)
        phase("kernel", name="fused_encoder_layer", B=TRAIN_B, L=length, rate=r,
              max_abs_err=err, atol=KERNEL_ATOL)
        phase("kernel", name="fused_encoder_layer_bwd", B=TRAIN_B, L=length, rate=r,
              grads=len(names), max_abs_err=gerr, at=gname, its_max=gmax,
              plain_f32_err=perr, rtol_of_max=GRAD_RTOL,
              **({} if full else {"gates_within_flip_eps": flips}))
        fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, gerr)
        del outs, grads
    with torch.no_grad():                 # the serving shapes, rate 0
        for rows in SERVE_ROWS if full else ():
            xs, ps = (randn(rng, (rows, length, d), device) for _ in range(2))
            ms_ = torch.from_numpy(ragged_mask(rng, rows, length, 1)).to(device)
            err = check_close(f"fused_encoder_layer rows {rows}",
                              fel.fused_encoder_layer(xs, ms_, ps, layer),
                              fel.fused_encoder_layer_reference(xs, ms_, ps, layer))
            kms, pms = in_turns(lambda: fel.fused_encoder_layer(xs, ms_, ps, layer),
                                lambda: fel.fused_encoder_layer_reference(xs, ms_, ps, layer))
            bms_, by = bound(encoder_flops(rows, length, d, ffn),
                             nbytes(xs, ps, ms_, xs, *params))
            phase("kernel", name="fused_encoder_layer", B=rows, L=length, rate=0.0,
                  max_abs_err=err, atol=KERNEL_ATOL, ms=f"{kms:.4f}", plain_ms=f"{pms:.4f}",
                  bound_ms=f"{bms_:.4f}", bound_by=by)
            fwd_err = max(fwd_err, err)

    with torch.no_grad():
        ms, plain_ms = in_turns(
            lambda: fel.fused_encoder_layer(x, mask, pos, layer, rate, DROPOUT_SEED),
            lambda: fel.fused_encoder_layer_reference(x, mask, pos, layer, rate, DROPOUT_SEED))
    xi, pi = x.clone().requires_grad_(), pos.clone().requires_grad_()
    out = fel.fused_encoder_layer_reference(xi, mask, pi, layer, rate, DROPOUT_SEED)
    fwd, bwd, acts = encoder_variants(layer, x, pos, mask, g, rate, "f32")
    bms, plain_bms = in_turns(
        bwd(acts), lambda: torch.autograd.grad(out, [xi, pi, *params], g, retain_graph=True))
    del out
    phase("kernel-time", name="fused_encoder_layer", B=TRAIN_B, L=length, rate=rate,
          ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    phase("kernel-time", name="fused_encoder_layer_bwd", B=TRAIN_B, L=length, rate=rate,
          ms=f"{bms:.4f}", plain_ms=f"{plain_bms:.4f}", given="the saved set")
    time_encoder_variants(fwd, bwd, acts, length, rate, "f32", full)
    del acts
    flops = encoder_flops(TRAIN_B, length, d, ffn)
    fwd_bytes = nbytes(x, pos, mask, x, *params)
    bwd_bytes = nbytes(x, pos, mask, g, *params, x, pos, *params)
    entries = [
        entry("fused_encoder_layer", "mgsv_tpu_torch/csrc/fused_encoder_layer.cu",
              "mgsv_tpu/ops/pallas/fused_encoder_layer.py:193", fwd_err, ms, plain_ms,
              flops, fwd_bytes),
        entry("fused_encoder_layer_bwd", "mgsv_tpu_torch/csrc/fused_encoder_layer_bwd.cu",
              "mgsv_tpu/ops/pallas/fused_encoder_layer_vjp.py:256", bwd_err, bms, plain_bms,
              2 * flops, bwd_bytes),
    ]
    bf16 = check_encoder_bf16(layer, layer64, names, x, pos, mask, g, rate, full)
    for e, fl, nb in zip(entries, (flops, 2 * flops), (fwd_bytes, bwd_bytes)):
        err16, ms16, plain16, ms32 = bf16[e["name"]]
        b16, by16 = bound(fl, nb, PEAK_BF16_FLOPS)
        e.update(bf16_max_abs_err=err16, bf16_ms=ms16, bf16_plain_ms=plain16,
                 bf16_bound_ms=b16, bf16_bound_by=by16, f32_ms_in_turns=ms32)
        phase("kernel-time", name=e["name"], precision="bf16", B=TRAIN_B, L=length,
              rate=rate, ms=f"{ms16:.4f}", f32_ms=f"{ms32:.4f}", plain_ms=f"{plain16:.4f}",
              bound_ms=f"{b16:.4f}", bound_by=by16, gflop=f"{fl / 1e9:.1f}",
              tflops=f"{fl / ms16 / 1e9:.1f}")
    if not full:
        for e in entries:
            e.update(name=f"{e['name']}@L{length}", shape=f"B={TRAIN_B} L={length}")
    return entries


def encoder_variants(layer, x, pos, mask, g, rate, precision):
    """(fwd, bwd, acts) at `precision`: fwd(train) a call of #1, its
    training variant (which keeps the saved set) or its inference one;
    bwd(acts) a call of #2 given the saved set, or recomputing it given
    None; acts the training variant's saved set, and #2 from it checked
    equal to the recompute bit for bit (what the step runs against what it
    ran before the saved set)."""
    def fwd(train):
        if train:
            return lambda: fel.fused_encoder_layer_fwd(x, mask, pos, layer, rate, DROPOUT_SEED,
                                                       precision)
        return lambda: fel.fused_encoder_layer(x, mask, pos, layer, rate, DROPOUT_SEED,
                                               precision)

    bwd = lambda acts: lambda: fel.fused_encoder_layer_bwd(x, mask, pos, g, layer, rate,
                                                           DROPOUT_SEED, precision, acts=acts)
    with torch.no_grad():
        out, acts = fwd(True)()
        same_out = torch.equal(out, fwd(False)())
    saved, recomputed = bwd(acts)(), bwd(None)()
    same = [torch.equal(a, c) for a, c in zip([saved[0], saved[1], *saved[2]],
                                              [recomputed[0], recomputed[1], *recomputed[2]])]
    phase("kernel", name="fused_encoder_layer_bwd", precision=precision, B=x.shape[0],
          L=x.shape[1], rate=rate, saved_set_equals_recompute=all(same),
          training_out_equals_inference=same_out)
    if not (all(same) and same_out):
        raise AssertionError(f"fused_encoder_layer {precision}: from the saved set the "
                             f"gradients equal the recompute's {same}, the outputs {same_out}")
    return fwd, bwd, acts


def time_encoder_variants(fwd, bwd, acts, length, rate, precision, breakdowns):
    """#1's training variant against its inference variant, and #2 from the
    saved set against the recompute, in turns; with `breakdowns`, each by
    kernel name ([breakdown] lines)."""
    with torch.no_grad():
        train_ms, infer_ms = in_turns(fwd(True), fwd(False))
    saved_ms, recompute_ms = in_turns(bwd(acts), bwd(None))
    phase("kernel-time", name="fused_encoder_layer", precision=precision, B=TRAIN_B, L=length,
          rate=rate, training_ms=f"{train_ms:.4f}", inference_ms=f"{infer_ms:.4f}")
    phase("kernel-time", name="fused_encoder_layer_bwd", precision=precision, B=TRAIN_B,
          L=length, rate=rate, saved_set_ms=f"{saved_ms:.4f}", recompute_ms=f"{recompute_ms:.4f}")
    if breakdowns:
        with torch.no_grad():
            breakdown("fused_encoder_layer", fwd(False), precision=precision)
            breakdown("fused_encoder_layer training variant", fwd(True), precision=precision)
        breakdown("fused_encoder_layer_bwd", bwd(acts), precision=precision, given="saved set")
        breakdown("fused_encoder_layer_bwd recomputing", bwd(None), precision=precision)


def check_encoder_bf16(layer, layer64, names, x, pos, mask, g, rate,
                       breakdowns: bool = True) -> dict:
    """Kernels #1 and #2 at precision "bf16" against the bf16 plain version
    (every product's operands rounded to bf16, float32 sums) at rates 0 and
    `rate`: the forward within BF16_ATOL and nearer the bf16 plain output
    than the float32 kernel's, every gradient against the float64 run of the
    same bf16 rounding (BF16_GRAD_RTOL); then each timed in turns with the
    bf16 plain version and with the float32 instantiation.  Returns {name:
    (max abs error, ms, plain ms, float32 ms)}."""
    params = list(layer.parameters())
    length = x.shape[1]
    fwd_err = bwd_err = 0.0
    for r in (0.0, rate):
        outs, grads = {}, {}
        for kind, fn, lay, dt in (("kernel", fel.fused_encoder_layer, layer, torch.float32),
                                  ("plain", fel.fused_encoder_layer_reference, layer,
                                   torch.float32),
                                  ("exact", fel.fused_encoder_layer_reference, layer64,
                                   torch.float64)):
            xi, pi = (t.detach().to(dt).requires_grad_() for t in (x, pos))
            out = fn(xi, mask.to(dt), pi, lay, r, DROPOUT_SEED, "bf16")
            grads[kind] = torch.autograd.grad(out, [xi, pi, *lay.parameters()], g.to(dt))
            outs[kind] = out.detach()
            del out
        with torch.no_grad():
            f32_gap = (fel.fused_encoder_layer(x, mask, pos, layer, r, DROPOUT_SEED)
                       - outs["plain"]).abs().max().item()
        err = (outs["kernel"] - outs["plain"]).abs().max().item()
        if not (torch.isfinite(outs["kernel"]).all() and err <= BF16_ATOL and err < f32_gap):
            raise AssertionError(f"fused_encoder_layer bf16 rate {r}: max abs error {err} "
                                 f"(tolerance {BF16_ATOL}; the float32 kernel's {f32_gap})")
        gerr, perr, gname, gmax = check_grads(f"fused_encoder_layer_bwd bf16 rate {r}", names,
                                              grads["kernel"], grads["plain"], grads["exact"],
                                              BF16_GRAD_RTOL)
        phase("kernel", name="fused_encoder_layer", precision="bf16", B=TRAIN_B, L=length,
              rate=r, max_abs_err=err, atol=BF16_ATOL, f32_kernel_vs_bf16_plain=f32_gap)
        phase("kernel", name="fused_encoder_layer_bwd", precision="bf16", B=TRAIN_B, L=length,
              rate=r, grads=len(names), max_abs_err=gerr, at=gname, its_max=gmax,
              plain_f32_err=perr, rtol_of_max=BF16_GRAD_RTOL)
        fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, gerr)
        del outs, grads
    fwd, bwd, acts = encoder_variants(layer, x, pos, mask, g, rate, "bf16")
    fwd32, bwd32, acts32 = encoder_variants(layer, x, pos, mask, g, rate, "f32")
    with torch.no_grad():
        ms, plain_ms = in_turns(fwd(False), lambda: fel.fused_encoder_layer_reference(
            x, mask, pos, layer, rate, DROPOUT_SEED, "bf16"))
        ms_b, ms32 = in_turns(fwd(False), fwd32(False))
    xi, pi = x.clone().requires_grad_(), pos.clone().requires_grad_()
    out = fel.fused_encoder_layer_reference(xi, mask, pi, layer, rate, DROPOUT_SEED, "bf16")
    bms, plain_bms = in_turns(bwd(acts), lambda: torch.autograd.grad(
        out, [xi, pi, *params], g, retain_graph=True))
    bms_b, bms32 = in_turns(bwd(acts), bwd32(acts32))
    del out, acts32
    time_encoder_variants(fwd, bwd, acts, length, rate, "bf16", breakdowns)
    del acts
    return {"fused_encoder_layer": (fwd_err, (ms + ms_b) / 2, plain_ms, ms32),
            "fused_encoder_layer_bwd": (bwd_err, (bms + bms_b) / 2, plain_bms, bms32)}


def check_xpool(device: torch.device) -> list:
    """Kernel #3 (forward and backward) against autograd through the plain
    version, at V = M = 512, S = 96, rates 0 and the configuration's."""
    cfg = Config()
    d, s, rate = cfg.model.dim_input, cfg.data.max_snippet_num, cfg.model.xpool_dropout
    vc = mc = TRAIN_B
    gen = torch.Generator().manual_seed(SEED + 1)
    weights = [w.detach() for w in perturb_(XPoolTransformer(d), gen).to(device).stage_weights()]
    rng = np.random.default_rng(SEED + 1)
    q, vhat = randn(rng, (vc, d), device), l2_normalize(randn(rng, (vc, d), device))
    k, v = (randn(rng, (mc, s, d), device) for _ in range(2))
    mask = torch.from_numpy(ragged_mask(rng, mc, s, 1)).to(device)
    g = randn(rng, (mc, vc), device)
    names = ["q", "k", "v", "vhat", "Wout", "bout", "g2", "b2", "Wlin", "blin", "g3", "b3"]
    fwd_err = bwd_err = 0.0
    for r in (0.0, rate):
        outs, grads = {}, {}
        for kind, fn, dt in (("kernel", xps.xpool_sim, torch.float32),
                             ("plain", xps.xpool_sim_reference, torch.float32),
                             ("exact", xps.xpool_sim_reference, torch.float64)):
            ins = [t.detach().to(dt).requires_grad_() for t in (q, k, v, vhat, *weights)]
            out = fn(ins[0], ins[1], ins[2], mask, ins[3], ins[4:], r, DROPOUT_SEED)
            grads[kind] = torch.autograd.grad(out, ins, g.to(dt))
            outs[kind] = out.detach()
            del out
        torch.cuda.synchronize()
        err = check_close(f"xpool_sim rate {r}", outs["kernel"], outs["plain"])
        gerr, perr, gname, gmax = check_grads(f"xpool_sim_bwd rate {r}", names,
                                              grads["kernel"], grads["plain"], grads["exact"])
        phase("kernel", name="xpool_sim_fwd", V=vc, M=mc, S=s, rate=r, max_abs_err=err,
              atol=KERNEL_ATOL)
        phase("kernel", name="xpool_sim_bwd", V=vc, M=mc, S=s, rate=r, grads=len(names),
              max_abs_err=gerr, at=gname, its_max=gmax, plain_f32_err=perr,
              rtol_of_max=GRAD_RTOL)
        fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, gerr)
        del outs, grads

    with torch.no_grad():
        ms, plain_ms = in_turns(
            lambda: xps.xpool_sim_fwd(q, k, v, mask, vhat, weights, rate, DROPOUT_SEED),
            lambda: xps.xpool_sim_reference(q, k, v, mask, vhat, weights, rate, DROPOUT_SEED))
    ins = [t.clone().requires_grad_() for t in (q, k, v, vhat, *weights)]
    out = xps.xpool_sim_reference(ins[0], ins[1], ins[2], mask, ins[3], ins[4:], rate,
                                  DROPOUT_SEED)
    bms, plain_bms = in_turns(
        lambda: xps.xpool_sim_bwd(q, k, v, mask, vhat, weights, g, rate, DROPOUT_SEED),
        lambda: torch.autograd.grad(out, ins, g, retain_graph=True))
    del out
    phase("kernel-time", name="xpool_sim_fwd", V=vc, M=mc, S=s, rate=rate, ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}")
    phase("kernel-time", name="xpool_sim_bwd", V=vc, M=mc, S=s, rate=rate, ms=f"{bms:.4f}",
          plain_ms=f"{plain_bms:.4f}")
    breakdown("xpool_sim_bwd", lambda: xps.xpool_sim_bwd(q, k, v, mask, vhat, weights, g, rate,
                                                         DROPOUT_SEED))
    phase("workspace", name="xpool_sim_fwd", V=vc, M=mc, S=s,
          bytes=xps.forward_workspace_bytes(vc, mc, s, device))
    breakdown("xpool_sim_fwd", lambda: xps.xpool_sim_fwd(q, k, v, mask, vhat, weights, rate,
                                                         DROPOUT_SEED), V=vc, M=mc, rate=rate)
    flops = xpool_pair_flops(vc, mc, s, d)
    src = "mgsv_tpu_torch/csrc/xpool_sim_train.cu"
    return [
        entry("xpool_sim_fwd", src, "mgsv_tpu/ops/pallas/xpool_sim_vjp.py:250", fwd_err,
              ms, plain_ms, flops, nbytes(q, k, v, mask, vhat, *weights, g)),
        entry("xpool_sim_bwd", src, "mgsv_tpu/ops/pallas/xpool_sim_vjp.py:301", bwd_err,
              bms, plain_bms, 2 * flops,
              nbytes(q, k, v, mask, vhat, *weights, g, q, k, v, vhat, *weights)),
    ]


def check_temporal(device: torch.device) -> list:
    """Kernel #5 (forward and backward) against autograd through the plain
    version at B=512 for each tower's L, rates 0 and the configuration's,
    the last row with no valid key; the backward twice, bit for bit; the
    forward at the evaluation's B=40, rate 0.  Returns the kernels-line
    entries at the audio tower's shape (the larger)."""
    cfg = Config()
    m = cfg.model
    d, heads, ffn, rate = m.dim_input, m.temporal_heads, m.temporal_mlp_dim, m.temporal_dropout
    gen = torch.Generator().manual_seed(SEED + 5)
    trm = TemporalTransformer(d, 1, heads, ffn, d)
    trm.reset_parameters(gen)
    layer = perturb_(trm.layers[0], gen).to(device)
    layer64 = copy.deepcopy(layer).double()
    params = list(layer.parameters())
    names = ["x"] + [n for n, _ in layer.named_parameters()]
    rng = np.random.default_rng(SEED + 5)
    out_entries = None
    for tower, length in (("audio", cfg.data.max_snippet_num), ("video", cfg.data.max_v_frames)):
        x, g = (randn(rng, (TRAIN_B, length, d), device) for _ in range(2))
        mask = torch.from_numpy(ragged_mask(rng, TRAIN_B, length, 1)).to(device)
        mask[-1] = 0.0                          # uniform weights, as the plain version
        fwd_err = bwd_err = 0.0
        for r in (0.0, rate):
            outs, grads = {}, {}
            for kind, fn, lay, dt in (
                    ("kernel", ftl.fused_temporal_layer, layer, torch.float32),
                    ("plain", ftl.fused_temporal_layer_reference, layer, torch.float32),
                    ("exact", ftl.fused_temporal_layer_reference, layer64, torch.float64)):
                xi = x.detach().to(dt).requires_grad_()
                out = fn(xi, mask.to(dt), lay, r, DROPOUT_SEED)
                grads[kind] = torch.autograd.grad(out, [xi, *lay.parameters()], g.to(dt))
                outs[kind] = out.detach()
                del out
            torch.cuda.synchronize()
            err = check_close(f"fused_temporal_layer {tower} rate {r}", outs["kernel"],
                              outs["plain"])
            gerr, perr, gname, gmax = check_grads(
                f"fused_temporal_layer_bwd {tower} rate {r}", names, grads["kernel"],
                grads["plain"], grads["exact"])
            phase("temporal-kernel", name="fused_temporal_layer", tower=tower, B=TRAIN_B, L=length,
                  rate=r, max_abs_err=err, atol=KERNEL_ATOL)
            phase("temporal-kernel", name="fused_temporal_layer_bwd", tower=tower, B=TRAIN_B,
                  L=length, rate=r, grads=len(names), max_abs_err=gerr, at=gname, its_max=gmax,
                  plain_f32_err=perr, rtol_of_max=GRAD_RTOL)
            fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, gerr)
            del outs, grads
        with torch.no_grad():
            _, acts = ftl.fused_temporal_layer_fwd(x, mask, layer, rate, DROPOUT_SEED)
        bwd_err = max(bwd_err, check_temporal_saved(f"{tower} B={TRAIN_B}", layer, layer64, names,
                                                    x, mask, g, rate, acts))

        with torch.no_grad():
            ms, plain_ms = in_turns(
                lambda: ftl.fused_temporal_layer(x, mask, layer, rate, DROPOUT_SEED),
                lambda: ftl.fused_temporal_layer_reference(x, mask, layer, rate, DROPOUT_SEED))
            train_ms = cuda_ms(lambda: ftl.fused_temporal_layer_fwd(
                x, mask, layer, rate, DROPOUT_SEED), 5)
        xi = x.clone().requires_grad_()
        out = ftl.fused_temporal_layer_reference(xi, mask, layer, rate, DROPOUT_SEED)
        bms, plain_bms = in_turns(      # given the saved set, as a training step runs it
            lambda: ftl.fused_temporal_layer_bwd(x, mask, g, layer, rate, DROPOUT_SEED,
                                                 acts=acts),
            lambda: torch.autograd.grad(out, [xi, *params], g, retain_graph=True))
        recompute_ms = cuda_ms(lambda: ftl.fused_temporal_layer_bwd(
            x, mask, g, layer, rate, DROPOUT_SEED), 5)
        del out
        flops = temporal_flops(TRAIN_B, length, d, ffn)
        fwd_bytes, bwd_bytes = nbytes(x, mask, x, *params), nbytes(x, mask, g, *params, x, *params)
        for name, t, pt, fl, nb in (("fused_temporal_layer", ms, plain_ms, flops, fwd_bytes),
                                    ("fused_temporal_layer_bwd", bms, plain_bms, 2 * flops,
                                     bwd_bytes)):
            b_ms, by = bound(fl, nb)
            phase("temporal-kernel-time", name=name, tower=tower, B=TRAIN_B, L=length, rate=rate,
                  ms=f"{t:.4f}", plain_ms=f"{pt:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=by,
                  gflop=f"{fl / 1e9:.1f}", tflops=f"{fl / t / 1e9:.1f}")
        phase("temporal-kernel-time", name="fused_temporal_layer_bwd", tower=tower, B=TRAIN_B,
              L=length, rate=rate, recomputing_ms=f"{recompute_ms:.4f}",
              training_forward_ms=f"{train_ms:.4f}")
        with torch.no_grad():
            if tower == "audio":
                breakdown("fused_temporal_layer", lambda: ftl.fused_temporal_layer(
                    x, mask, layer, rate, DROPOUT_SEED), tower=tower, B=TRAIN_B, rate=rate)
            breakdown("fused_temporal_layer training", lambda: ftl.fused_temporal_layer_fwd(
                x, mask, layer, rate, DROPOUT_SEED), tower=tower, B=TRAIN_B, rate=rate)
        breakdown("fused_temporal_layer_bwd", lambda: ftl.fused_temporal_layer_bwd(
            x, mask, g, layer, rate, DROPOUT_SEED, acts=acts), tower=tower, B=TRAIN_B, rate=rate,
            given="saved")
        breakdown("fused_temporal_layer_bwd", lambda: ftl.fused_temporal_layer_bwd(
            x, mask, g, layer, rate, DROPOUT_SEED), tower=tower, B=TRAIN_B, rate=rate,
            given="recomputing")
        del acts

        xs = randn(rng, (EVAL_B, length, d), device)             # the evaluation's shape
        ms_ = torch.from_numpy(ragged_mask(rng, EVAL_B, length, 1)).to(device)
        with torch.no_grad():
            err = check_close(f"fused_temporal_layer {tower} B={EVAL_B}",
                              ftl.fused_temporal_layer(xs, ms_, layer),
                              ftl.fused_temporal_layer_reference(xs, ms_, layer))
            kms, pms = in_turns(lambda: ftl.fused_temporal_layer(xs, ms_, layer),
                                lambda: ftl.fused_temporal_layer_reference(xs, ms_, layer))
        e_ms, by = bound(temporal_flops(EVAL_B, length, d, ffn), nbytes(xs, ms_, xs, *params))
        phase("temporal-kernel", name="fused_temporal_layer", tower=tower, B=EVAL_B, L=length,
              rate=0.0, max_abs_err=err, atol=KERNEL_ATOL, ms=f"{kms:.4f}", plain_ms=f"{pms:.4f}",
              bound_ms=f"{e_ms:.4f}", bound_by=by)
        fwd_err = max(fwd_err, err)
        if tower == "audio":
            src = "mgsv_tpu_torch/csrc/fused_temporal_layer"
            out_entries = [
                entry("fused_temporal_layer", f"{src}.cu",
                      "mgsv_tpu/ops/pallas/fused_temporal_layer.py:349", fwd_err, ms, plain_ms,
                      flops, fwd_bytes),
                entry("fused_temporal_layer_bwd", f"{src}_bwd.cu",
                      "mgsv_tpu/ops/pallas/fused_temporal_layer.py:381", bwd_err, bms, plain_bms,
                      2 * flops, bwd_bytes)]
        del x, g, mask, xs, ms_
    rng = np.random.default_rng(SEED + 15)            # a ragged last tile, fewer rows than one
    for b, length in ((13, 37), (3, 21)):
        x, g = (randn(rng, (b, length, d), device) for _ in range(2))
        mask = torch.from_numpy(ragged_mask(rng, b, length, 1)).to(device)
        mask[-1] = 0.0
        with torch.no_grad():
            _, acts = ftl.fused_temporal_layer_fwd(x, mask, layer, rate, DROPOUT_SEED)
        check_temporal_saved(f"B={b} L={length}", layer, layer64, names, x, mask, g, rate, acts)
    return out_entries


def check_temporal_saved(what: str, layer, layer64, names, x, mask, g, rate, acts) -> float:
    """#5's training forward's saved set against its plain version, and the
    backward given it: equal to the recomputing backward bit for bit, two
    calls bit-identical, and held against the plain backward from the saved
    set (`temporal_layer_bwd_from_acts_reference`, float32 and float64) as
    check_grads holds gradients.  Returns the gradients' largest error."""
    with torch.no_grad():
        _, exact_acts = ftl.temporal_layer_acts_reference(x.double(), mask.double(), layer64,
                                                          rate, DROPOUT_SEED)
    act_err = 0.0
    for name, got, want in zip(ftl.SAVED, acts, exact_acts):
        err = (got.double() - want).abs().max().item()
        tol = KERNEL_ATOL * max(1.0, want.abs().max().item())
        if not torch.isfinite(got).all() or not err <= tol:
            raise AssertionError(f"fused_temporal_layer {what} saved {name}: max abs error {err}")
        act_err = max(act_err, err)
    saved, again, recomputed = (
        ftl.fused_temporal_layer_bwd(x, mask, g, layer, rate, DROPOUT_SEED, acts=a)
        for a in (acts, acts, None))
    flat = lambda r: [r[0], *r[1]]
    if not all(torch.equal(a, b) for a, b in zip(flat(saved), flat(recomputed))):
        raise AssertionError(f"fused_temporal_layer_bwd {what}: the saved set's backward differs "
                             f"from the recomputing one")
    if not all(torch.equal(a, b) for a, b in zip(flat(saved), flat(again))):
        raise AssertionError(f"fused_temporal_layer_bwd {what}: two calls differ")
    with torch.no_grad():
        plain = flat(ftl.temporal_layer_bwd_from_acts_reference(
            x, mask, g, layer, ftl.temporal_layer_acts_reference(x, mask, layer, rate,
                                                                 DROPOUT_SEED)[1],
            rate, DROPOUT_SEED))
        exact = flat(ftl.temporal_layer_bwd_from_acts_reference(
            x.double(), mask.double(), g.double(), layer64, exact_acts, rate, DROPOUT_SEED))
    by_name = dict(zip(map(id, ftl._layer_tensors(layer)), range(1, 13)))
    order = [0] + [by_name[id(p)] for p in layer.parameters()]     # names' order
    gerr, perr, gname, _ = check_grads(f"fused_temporal_layer_bwd {what} from the saved set",
                                       names, *([r[i] for i in order]
                                                for r in (flat(saved), plain, exact)))
    phase("temporal-kernel", name="fused_temporal_layer_bwd", shape=what, rate=rate,
          saved_equals_recomputing=True, two_calls_equal=True, saved_set_max_abs_err=act_err,
          vs_plain_from_saved_set_err=gerr, at=gname, plain_f32_err=perr)
    return gerr


def train_setup(cfg: Config, device: torch.device, model=None, fused_decoder: bool = False):
    model = model if model is not None else MaDe(
        cfg, torch.Generator().manual_seed(SEED)).to(device)
    optimizer = make_optimizer(model, cfg, total_steps=HORIZON)
    return model, make_train_step(model, cfg, optimizer, fused_decoder)


def multi_query(cfg: Config, dtype: str = None, detr_dropout: float = 0.0) -> Config:
    """cfg with Q_MULTI moment queries and the DETR dropout rate (0 for the
    fused decoder, which has none); dtype, when given, the compute dtype."""
    over = dict(num_moment_queries=Q_MULTI, detr_dropout=detr_dropout)
    if dtype:
        over["compute_dtype"] = dtype
    return cfg.replace(model=dataclasses.replace(cfg.model, **over))


@contextlib.contextmanager
def recording_lsap(solves: list):
    """lsap.solve_batch recording each (cost, col_to_row) it returns."""
    solve = lsap.solve_batch

    def record(cost):
        out = solve(cost)
        solves.append((cost.detach().clone(), out.clone()))
        return out

    with mock.patch.object(lsap, "solve_batch", record):
        yield


def check_lsap(solves: list) -> int:
    """Every recorded assignment against SciPy's on the same cost: a
    matching whose total over the real pairs is SciPy's optimum.  Returns
    the number of problems checked."""
    from scipy.optimize import linear_sum_assignment

    n = 0
    for cost, c2r in solves:
        cost, c2r = cost.double().cpu().numpy(), c2r.cpu().numpy()
        rows = cost.shape[1]
        for c, a in zip(cost, c2r):
            real = a < rows
            ri, ci = linear_sum_assignment(c)
            if len(set(a[real])) != real.sum() or real.sum() != len(ri) or not abs(
                    c[a[real], np.flatnonzero(real)].sum() - c[ri, ci].sum()) <= 1e-4:
                raise AssertionError(f"LSAP {a} is not SciPy's optimum ({ri}, {ci}) on {c}")
            n += 1
    return n


# The ReLU sites a step runs as PyTorch modules (the DETR layers' linear1
# outside the kernels, the MLP heads' hidden layers, the EmbeddingNets'
# BatchNorms): their pre-activations.
RELU_SITES = re.compile(r"(encoder|decoder)\.layers\.\d+\.linear1$"
                        r"|(span_embed|moment_embed|reg_mlp)\.layers\.[01]$"
                        r"|embedding_net\.net\.[14]$")
# A gate whose pre-activation lies within this of zero in one run may fall
# the other way in another float32 run (the step's rounding reaches 1e-6 of
# an order-1 pre-activation) and then moves a gradient by a whole term.
STEP_FLIP_EPS = 1e-4


def record_gates(model, store: dict) -> list:
    """Forward hooks keeping each ReLU site's pre-activation, by name."""
    return [mod.register_forward_hook(
        lambda m, i, o, n=n: store.setdefault(n, []).append(o.detach()))
        for n, mod in model.named_modules() if RELU_SITES.search(n)]


def impose_gates(model, gates: dict, counts: list, mesh=None) -> list:
    """Forward hooks that give each ReLU site the gates `gates` recorded
    where its own pre-activation lies within STEP_FLIP_EPS of zero and on
    the other side: the value is negated there (it moves by under
    2 STEP_FLIP_EPS) with a gradient of 1, so the gate turns.  The flips
    made are appended to `counts`.  mesh: the gates were recorded over the
    global batch and the model runs this rank's rows; each call takes the
    rank's dp index's block of the axis on which the two sizes differ (the
    batch axis)."""
    hooks = []
    for n, mod in model.named_modules():
        if n in gates:
            calls = iter(gates[n])

            def hook(m, i, o, calls=calls):
                want = next(calls).to(o.device)
                if want.shape != o.shape:
                    axis = next(a for a in range(o.dim()) if o.shape[a] != want.shape[a])
                    want = want.narrow(axis, mesh.dp_index * o.shape[axis], o.shape[axis])
                want = want.to(o.dtype) > 0
                flip = ((o > 0) != want) & (o.abs() < STEP_FLIP_EPS)
                counts.append(int(flip.sum()))
                return torch.where(flip, o - 2 * o.detach(), o)

            hooks.append(mod.register_forward_hook(hook))
    return hooks


def train_runs(device: torch.device, cfg: Config, batch_size: int = TRAIN_B,
               fused_decoder: bool = False, hooks=None, share_gates: bool = False) -> dict:
    """One float32 step of cfg through the kernels, one through the plain
    versions and one through the plain versions in float64, from the same
    weights, batch and seed: {"logs", "grads", "launches"} by run
    ("kernel", "plain", "exact"), the EmbeddingNets' running buffers after
    the step ("buffers", by run), the kernel step's "device_ops", "peak_gb"
    and every LSAP solve it made ("solves"), and the "batch".
    hooks(model), when given, is called on the kernel step's model before
    it runs.  share_gates: the plain and float64 steps take the kernel
    step's gates at the ReLU sites outside the kernels wherever their own
    pre-activation lies within STEP_FLIP_EPS of zero (impose_gates), so a
    gate that rounding puts on the other side in one run moves no gradient
    by a whole term; "flips" counts the gates so turned."""
    batch = to_tensors(example_batch(np.random.RandomState(SEED), cfg, batch_size), device)
    model, _ = train_setup(cfg, device)
    runs = {"kernel": (model, batch, False),
            "plain": (copy.deepcopy(model), batch, True),
            "exact": (copy.deepcopy(model).double(),
                      {k: v.double() if v.is_floating_point() else v for k, v in batch.items()},
                      True)}
    if hooks is not None:
        hooks(model)
    logs, grads, launches, solves, gates, flips, buffers = {}, {}, {}, [], {}, {}, {}
    for kind, (mdl, b, plain) in runs.items():
        _, step = train_setup(cfg, device, model=mdl, fused_decoder=fused_decoder)
        counts = []
        gate_hooks = [] if not share_gates else (
            record_gates(mdl, gates) if kind == "kernel" else impose_gates(mdl, gates, counts))
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with plain_kernels() if plain else recording_lsap(solves), \
                torch.profiler.profile(activities=acts) if kind == "kernel" else \
                contextlib.nullcontext() as prof:
            log = step(b)
            torch.cuda.synchronize()
        for h in gate_hooks:
            h.remove()
        flips[kind] = sum(counts)
        if kind == "kernel":         # the step's device operations and its peak memory
            device_ops = sum(e.count for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA)
            peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        launches[kind] = read_counts()
        logs[kind] = {k: float(v.double().mean()) for k, v in log.items()}
        grads[kind] = {n: p.grad for n, p in mdl.named_parameters() if p.grad is not None}
        buffers[kind] = {n: b.detach().clone() for n, b in mdl.named_buffers()
                         if n.endswith(("running_mean", "running_var"))}
        del log, step
    return {"logs": logs, "grads": grads, "launches": launches, "device_ops": device_ops,
            "peak_gb": peak_gb, "solves": solves, "batch": batch, "flips": flips,
            "buffers": buffers, "gates": gates}


def hold_step(what: str, runs: dict, want_launches: dict) -> tuple:
    """The kernel step's launches, finite logs, loss and every gradient
    against the float64 step, with the float32 plain step's error as the
    allowance (LOSS_RTOL, GRAD_RTOL); the plain steps launch nothing.
    Returns (losses by run, worst gradient error, the plain run's, number
    of gradients)."""
    logs, grads, launches = runs["logs"], runs["grads"], runs["launches"]
    if launches["kernel"] != want_launches:
        raise AssertionError(f"{what}: kernel step launches {launches['kernel']}, "
                             f"want {want_launches}")
    if any(launches["plain"].values()) or any(launches["exact"].values()):
        raise AssertionError(f"{what}: a plain step launched kernels: {launches}")
    for kind, log in logs.items():
        if not all(np.isfinite(v) for v in log.values()):
            raise AssertionError(f"{what}: {kind} step log not finite: {log}")
    loss = {kind: log["loss"] for kind, log in logs.items()}
    tol = LOSS_RTOL * abs(loss["exact"]) + 2 * abs(loss["plain"] - loss["exact"])
    if not abs(loss["kernel"] - loss["exact"]) <= tol:
        raise AssertionError(f"{what}: step loss {loss} (tolerance {tol})")
    names = list(grads["exact"])
    if not grads["kernel"].keys() == grads["plain"].keys() == grads["exact"].keys():
        raise AssertionError(f"{what}: the steps gave gradients to different parameters")
    worst, worst_plain, _, _ = check_grads(
        what, names, *([grads[k][n] for n in names] for k in ("kernel", "plain", "exact")))
    return loss, worst, worst_plain, len(names)


def check_train(device: torch.device, fused_temporal: bool = False,
                fused_decoder: bool = False) -> dict:
    """One float32 step through the kernels, one through the plain versions
    and one through the plain versions in float64, from the same weights,
    batch and seed; returns the kernel step's launch counts.  fused_decoder:
    Q_MULTI moment queries, the decoder on #6 (detr_dropout 0), the step's
    LSAP solves held against SciPy, and then the refusal of the same step
    at detr_dropout 0.1."""
    base = Config()
    cfg = base.replace(model=dataclasses.replace(base.model, compute_dtype="float32",
                                                 fused_temporal=fused_temporal))
    if fused_decoder:
        cfg = multi_query(cfg)
    # the plain and float64 steps take the kernel step's gates where rounding
    # alone puts a ReLU pre-activation on the other side of zero
    runs = train_runs(device, cfg, TRAIN_B, fused_decoder, share_gates=True)
    loss, worst, worst_plain, n_grads = hold_step("train step", runs,
                                                  per_step(cfg, fused_decoder))
    logs, solves = runs["logs"], runs["solves"]
    tag = "train-q" if fused_decoder else "temporal-train" if fused_temporal else "train"
    extra = {}
    if fused_decoder:
        extra = dict(queries=Q_MULTI, fused_decoder=True, lsap_solves=len(solves),
                     lsap_problems_vs_scipy=check_lsap(solves))
    phase(tag, dtype="float32", B=TRAIN_B, fused_temporal=fused_temporal, **extra,
          loss=loss["kernel"], plain_loss=loss["plain"], float64_loss=loss["exact"],
          params=n_grads, grad_max_abs_err=worst, plain_f32_grad_err=worst_plain,
          gates_turned_plain=runs["flips"]["plain"], gates_turned_float64=runs["flips"]["exact"],
          train_iou=logs["kernel"]["train_iou"], grad_norm=logs["kernel"]["grad_norm"],
          device_ops=runs["device_ops"], peak_mem_gb=f"{runs['peak_gb']:.2f}")
    phase("launches", path="train step" + (" fused_temporal" if fused_temporal else "")
          + (f" Q={Q_MULTI} fused_decoder" if fused_decoder else ""),
          **runs["launches"]["kernel"])
    if fused_decoder:
        _, step = train_setup(multi_query(cfg, detr_dropout=0.1), device, fused_decoder=True)
        try:
            step(runs["batch"])
        except ValueError as err:
            phase("train-q", detr_dropout=0.1, fused_decoder=True, raised=json.dumps(str(err)))
        else:
            raise AssertionError("fused_decoder=True trained with detr_dropout 0.1")
    return runs["launches"]["kernel"]


def check_timed(device: torch.device, card: str) -> None:
    """A few steps of the default bf16 configuration at B=512 (its encoder
    layers on #1/#2 at precision "bf16"), of the same with fused_temporal
    (its towers in float32), and of Q_MULTI moment queries (detr_dropout 0)
    with the plain decoder and with fused_decoder (its decoder in float32
    on #6), timed in turns: each configuration, then all in reverse."""
    base = Config()
    q_cfg = multi_query(base)
    cfgs = {"default": (base, False),
            "fused_temporal": (base.replace(model=dataclasses.replace(base.model,
                                                                      fused_temporal=True)),
                               False),
            f"q{Q_MULTI}": (q_cfg, False), f"q{Q_MULTI}_fused_decoder": (q_cfg, True)}
    batch = to_tensors(example_batch(np.random.RandomState(SEED), base, TRAIN_B), device)
    steps = {}
    for name, (cfg, fused_decoder) in cfgs.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")       # the fused towers ignore bf16 by design
            _, steps[name] = train_setup(cfg, device, fused_decoder=fused_decoder)
        steps[name](batch)                        # first use: allocator, cuBLAS
    torch.cuda.synchronize()
    seconds, peak = dict.fromkeys(cfgs, 0.0), dict.fromkeys(cfgs, 0)
    for name in [*cfgs, *reversed(cfgs)]:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            log = steps[name](batch)
        torch.cuda.synchronize()
        seconds[name] += time.perf_counter() - t0
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated(device))
        loss = float(log["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"bf16 step loss {loss} ({name})")
    peak_tf = peak_tflops(torch.cuda.get_device_name(device), "bfloat16")
    for name, dt in seconds.items():
        n = 2 * TIMED_STEPS
        # the analytic count (core/flops.py) over the measured step: a
        # reading of the step against the card's bf16 peak, no bound
        tflops = train_step_flops(cfgs[name][0], TRAIN_B)["train_step"] / (dt / n) / 1e12
        phase("timed", config=name, dtype="bfloat16", B=TRAIN_B, steps=n,
              step_ms=f"{dt / n * 1e3:.2f}", clips_per_s=f"{TRAIN_B * n / dt:.1f}",
              tflops=f"{tflops:.2f}", mfu=f"{tflops / peak_tf:.4f}" if peak_tf else "null",
              peak_mem_gb=f"{peak[name] / 1e9:.2f}", card=json.dumps(card))


def timed_query(engine: RetrievalEngine, feats, mask, top_k: int = 5):
    t0 = time.perf_counter()
    res = engine.query(feats, mask, top_k=top_k)
    return res, (time.perf_counter() - t0) * 1e3


def check_results(res, b: int, top_k: int, cfg: Config) -> None:
    if len(res) != b:
        raise AssertionError(f"{len(res)} results for {b} queries")
    for r in res:
        spans = np.asarray(r["moments"])
        scores = np.asarray(r["retrieval_scores"])
        if len(r["music_ids"]) != top_k or spans.shape != (top_k, 2):
            raise AssertionError(f"bad result shape: {r}")
        if not (np.isfinite(spans).all() and np.isfinite(scores).all()
                and np.isfinite(r["moment_scores"]).all()):
            raise AssertionError("non-finite values in a query result")
        if np.any(np.diff(scores) > 0):
            raise AssertionError("retrieval scores are not ranked")
        if np.any(np.abs(spans) > 2 * cfg.data.max_m_duration):
            raise AssertionError(f"moments off the music time scale: {spans}")


def compare(fused, plain) -> tuple:
    span_err = score_err = 0.0
    for a, b in zip(fused, plain):
        if a["music_ids"] != b["music_ids"]:
            raise AssertionError(f"ranking differs: {a['music_ids']} vs {b['music_ids']}")
        span_err = max(span_err, np.abs(np.subtract(a["moments"], b["moments"])).max())
        score_err = max(score_err,
                        np.abs(np.subtract(a["moment_scores"], b["moment_scores"])).max(),
                        np.abs(np.subtract(a["retrieval_scores"],
                                           b["retrieval_scores"])).max())
    if not (span_err <= SPAN_ATOL_S and score_err <= SCORE_ATOL):
        raise AssertionError(f"kernel engine vs plain engine: span {span_err} s, "
                             f"score {score_err}")
    return span_err, score_err


def check_slice(device: torch.device):
    """Index + queries at full width; returns (engine, videos, masks)."""
    base = Config()
    cfg = base.replace(model=dataclasses.replace(base.model, compute_dtype="float32"))
    data, m = cfg.data, cfg.model
    rng = np.random.default_rng(SEED)
    model = MaDe(cfg, torch.Generator().manual_seed(SEED)).to(device).eval()

    t0 = time.perf_counter()
    feats = rng.standard_normal((N_TRACKS, data.max_snippet_num, data.ast_dim),
                                dtype=np.float32)
    masks = ragged_mask(rng, N_TRACKS, data.max_snippet_num, 8)
    index = build_music_index(model, [f"track{i:05d}" for i in range(N_TRACKS)],
                              feats, masks, batch_size=256)
    del feats
    phase("index", tracks=N_TRACKS, snippets=data.max_snippet_num,
          token_store_mb=f"{index.seg_tokens.nbytes / 2**20:.1f}",
          seconds=f"{time.perf_counter() - t0:.2f}")

    videos = rng.standard_normal((32, data.max_v_frames, data.vit_dim), dtype=np.float32)
    vmask = ragged_mask(rng, 32, data.max_v_frames, 5)
    engine = RetrievalEngine(model, cfg, index)
    if not engine.use_fused_kernels:
        raise AssertionError("the engine on a CUDA device must default to the kernel")
    plain_engine = RetrievalEngine(model, cfg, index, use_fused_kernels=False)
    batches = [(videos[:1], vmask[:1]), (videos, vmask)]
    for feats_b, mask_b in batches:          # first use: allocator, cuBLAS handles
        engine.query(feats_b, mask_b)
        plain_engine.query(feats_b, mask_b)

    reset_counts()
    fused_runs = [timed_query(engine, f, mk) for f, mk in batches]
    launches = read_counts()
    want = dict.fromkeys(COUNTERS, 0)
    want["fused_encoder_layer"] = m.detr_enc_layers * len(batches)
    if launches != want:
        raise AssertionError(f"serving launches {launches}, expected "
                             f"{m.detr_enc_layers} encoder-layer launches per query call")
    for (res, ms), (feats_b, mask_b) in zip(fused_runs, batches):
        check_results(res, feats_b.shape[0], 5, cfg)
        plain, plain_ms = timed_query(plain_engine, feats_b, mask_b)
        span_err, score_err = compare(res, plain)
        phase("slice", B=feats_b.shape[0], top_k=5, dtype="float32", ms=f"{ms:.2f}",
              plain_ms=f"{plain_ms:.2f}", span_err_s=span_err, score_err=score_err)
    phase("launches", path="serving", fused_encoder_layer=launches["fused_encoder_layer"])

    bf16_model = MaDe(base, torch.Generator().manual_seed(SEED)).to(device).eval()
    bf16_engine = RetrievalEngine(bf16_model, base, index)
    for feats_b, mask_b in batches:
        bf16_engine.query(feats_b, mask_b)
        res, ms = timed_query(bf16_engine, feats_b, mask_b)
        check_results(res, feats_b.shape[0], 5, base)
        phase("slice", B=feats_b.shape[0], top_k=5, dtype="bfloat16", ms=f"{ms:.2f}")
    return engine, videos, vmask


def check_http(engine: RetrievalEngine, videos, vmask) -> None:
    from mgsv_tpu_torch.serve.server import RetrievalServer

    server = RetrievalServer(engine, host="127.0.0.1", port=0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        if health["status"] != "ok" or health["index_size"] != len(engine.index.music_ids):
            raise AssertionError(f"bad /healthz reply: {health}")
        for i in range(3):
            body = json.dumps({"frame_feats": videos[i:i + 1].tolist(),
                               "frame_mask": vmask[i:i + 1].tolist(), "top_k": 5})
            conn.request("POST", "/query", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            reply = json.loads(resp.read())
            direct = engine.query(videos[i:i + 1], vmask[i:i + 1], top_k=5)
            if resp.status != 200 or reply["results"] != direct:
                raise AssertionError(f"/query reply {reply} != direct {direct}")
        phase("http", healthz="ok", queries=3, equal_to_direct=True)
    finally:
        server.stop()


def xpool_pair_flops(vc: int, mc: int, s: int, d: int) -> int:
    """The least work of the pair chain.  Per (video, track): scores and
    p.u (4 S D), Wlin (2 D^2), the cosine (2 D).  Wout is linear and acts
    on a softmax-weighted sum, so it is applied once per snippet of each
    track (M S 2 D^2, u = v Wout^T) and not once per pair, as the kernel
    does."""
    return vc * mc * (4 * s * d + 2 * d * d + 2 * d) + mc * s * 2 * d * d


def check_eval_kernel(device: torch.device) -> dict:
    """Kernel #4 against its plain version at V = M = 2,048, S = 96, ragged
    snippet masks and X-Pool weights off identity: the wrapper alone against
    `xpool_sim_eval_reference` on the same inputs, and `xpool_sim_fused`
    against `xpool_similarity_blocked` (the evaluation's plain path); then
    the serving scan's shape, for information."""
    cfg = Config()
    d, s = cfg.model.dim_input, cfg.data.max_snippet_num
    gen = torch.Generator().manual_seed(SEED + 2)
    xpool = perturb_(XPoolTransformer(d), gen).to(device)
    rng = np.random.default_rng(SEED + 2)
    out = {}
    for vc, mc in ((EVAL_N, EVAL_N), (SERVE_V, N_TRACKS)):
        video, segs = randn(rng, (vc, d), device), randn(rng, (mc, s, d), device)
        mask = torch.from_numpy(ragged_mask(rng, mc, s, 1)).to(device)
        ins = xpool_eval_inputs(video, segs, mask, xpool)
        with torch.no_grad():
            before = xps.xpool_sim_eval.launches
            got = xps.xpool_sim_eval(*ins)
            if xps.xpool_sim_eval.launches != before + 1:
                raise AssertionError("xpool_sim_eval: not one launch")
            err = check_close(f"xpool_sim_eval V={vc} M={mc}", got,
                              xps.xpool_sim_eval_reference(*ins))
            fn_err = check_close(f"xpool_sim_fused V={vc} M={mc}",
                                 xpool_sim_fused(video, segs, mask, xpool),
                                 xpool_similarity_blocked(xpool, video, segs, mask))
            ms, plain_ms = in_turns(lambda: xps.xpool_sim_eval(*ins),
                                    lambda: xps.xpool_sim_eval_reference(*ins))
            fn_ms, blocked_ms = in_turns(
                lambda: xpool_sim_fused(video, segs, mask, xpool),
                lambda: xpool_similarity_blocked(xpool, video, segs, mask), iters=2)
            if vc == EVAL_N:
                phase("workspace", name="xpool_sim_eval", V=vc, M=mc, S=s,
                      bytes=xps.forward_workspace_bytes(vc, mc, s, device))
                breakdown("xpool_sim_eval", lambda: xps.xpool_sim_eval(*ins), V=vc, M=mc)
        flops = xpool_pair_flops(vc, mc, s, d)
        nb = nbytes(*ins[:5], *ins[5], got)
        bms, by = bound(flops, nb)
        phase("eval-kernel", name="xpool_sim_eval", V=vc, M=mc, S=s, max_abs_err=err,
              fused_vs_blocked_err=fn_err, atol=KERNEL_ATOL, ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by,
              gflop=f"{flops / 1e9:.1f}", tflops=f"{flops / ms / 1e9:.1f}",
              fused_fn_ms=f"{fn_ms:.4f}", blocked_fn_ms=f"{blocked_ms:.4f}")
        out[(vc, mc)] = (max(err, fn_err), ms, plain_ms, flops, nb)
        del video, segs, mask, ins, got
    err, ms, plain_ms, flops, nb = out[(EVAL_N, EVAL_N)]
    return entry("xpool_sim_eval", "mgsv_tpu_torch/csrc/xpool_sim_train.cu",
                 "mgsv_tpu/ops/pallas/xpool_sim.py:79", err, ms, plain_ms, flops, nb)


def expected_fit_launches(cfg: Config, n_rows: int) -> dict:
    """Launches of one `fit` epoch on n_rows: its steps (`per_step` each),
    then one evaluation (`eval_launches`)."""
    steps = n_rows // cfg.train.batch_size_train
    evals = eval_launches(cfg, n_rows)
    return {name: steps * n + evals[name] for name, n in per_step(cfg).items()}


def eval_launches(cfg: Config, n_rows: int, fused_decoder: bool = False) -> dict:
    """Launches of one evaluation of n_rows at batch_size_val: per batch the
    encoder layers at rate 0 and the in-batch similarity's forward (#3),
    each where a step takes them, with fused_temporal the towers' temporal
    layers at rate 0 (#5) and with fused_decoder the decoder layers (#6),
    then one corpus similarity (#4) where vmr_loss ranks by the pooled
    X-Pool similarity (JAX evaluator.py:283-307)."""
    batches = -(-n_rows // cfg.train.batch_size_val)
    one = per_step(cfg, fused_decoder)
    pooled = "XA" in cfg.model.vmr_fusion and cfg.loss.vmr_loss in (
        "single", "dual_single_sim_fuse", "dual_single_loss_fuse")
    return {"fused_encoder_layer": one["fused_encoder_layer"] * batches,
            "fused_encoder_layer_bwd": 0, "xpool_sim_fwd": one["xpool_sim_fwd"] * batches,
            "xpool_sim_bwd": 0, "xpool_sim_eval": int(pooled), "flash_attention": 0,
            "fused_temporal_layer": one["fused_temporal_layer"] * batches,
            "fused_temporal_layer_bwd": 0,
            "fused_decoder_layer": one["fused_decoder_layer"] * batches,
            "fused_decoder_layer_bwd": 0}


@contextlib.contextmanager
def host_feeds():
    """(the Trainer's, the evaluator's) calls of the host pipeline, counted."""
    with mock.patch("mgsv_tpu_torch.train.loop.prefetch_epoch", wraps=prefetch_epoch) as tr, \
            mock.patch("mgsv_tpu_torch.eval.evaluator.prefetch_epoch",
                       wraps=prefetch_epoch) as ev:
        yield tr, ev


def check_train_cli(tmp: str) -> tuple:
    """`cli.train` on EVAL_N generated rows, one epoch of the default
    Config(), its data resident on the card through train.device_data
    "auto" (no host pipeline call); returns (run directory, data root, the
    epoch's record, the run's launch counts)."""
    out_dir = os.path.join(tmp, "train")
    cfg = Config()
    reset_counts()
    t0 = time.perf_counter()
    with host_feeds() as (tr, ev):
        train_cli.main(["--synthetic", str(EVAL_N), "--train.epochs", "1",
                        "--train.output_dir", out_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if tr.call_count or ev.call_count:
        raise AssertionError(f"train-cli fed from the host under device_data auto: "
                             f"{tr.call_count} training, {ev.call_count} evaluation epochs")
    run_dir = os.path.join(out_dir, cfg.train.name)
    with open(os.path.join(run_dir, "history.json")) as f:
        history = json.load(f)
    if len(history) != 1 or not np.isfinite(history[0]["train"]["loss"]):
        raise AssertionError(f"train-cli history: {history}")
    mgr = CheckpointManager(run_dir)
    tags = ("best_r1", "best_iou", "best_r1iou07", "last")
    if not all(mgr.exists(t) for t in tags):
        raise AssertionError(f"train-cli checkpoints missing: {os.listdir(run_dir)}")
    want = expected_fit_launches(cfg, EVAL_N)
    if launches != want:
        raise AssertionError(f"train-cli launches {launches}, want {want}")
    rec = history[0]
    phase("train-cli", rows=EVAL_N, device_data="resident", steps=rec["train"]["steps"],
          loss=rec["train"]["loss"],
          train_seconds=f"{rec['train']['seconds']:.3f}",
          clips_per_s=f"{rec['train']['clips_per_sec']:.1f}", R1=rec["eval"]["R1"],
          mIoU=rec["eval"]["mIoU"], checkpoints=",".join(tags),
          seconds_with_data_and_eval=f"{seconds:.2f}")
    phase("launches", path=f"train-cli epoch ({rec['train']['steps']} steps + 1 eval)",
          **launches)
    return run_dir, os.path.join(out_dir, "synthetic_data"), rec, launches


def check_train_cli_fused(tmp: str, data_root: str) -> dict:
    """`cli.train --model.fused_temporal true` for one epoch on the rows the
    train-cli phase generated (read as a CSV and stores: no new data);
    returns the run's launch counts."""
    base = Config()
    cfg = base.replace(model=dataclasses.replace(base.model, fused_temporal=True))
    out_dir, csv = os.path.join(tmp, "train_fused"), os.path.join(data_root, "data.csv")
    reset_counts()
    t0 = time.perf_counter()
    result = train_cli.main(["--train.epochs", "1", "--train.output_dir", out_dir,
                             "--model.fused_temporal", "true", "--data.train_csv", csv,
                             "--data.val_csv", csv, "--data.feature_root", data_root])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    rec = result["history"][0]
    if len(result["history"]) != 1 or not np.isfinite(rec["train"]["loss"]):
        raise AssertionError(f"train-cli-fused history: {result['history']}")
    want = expected_fit_launches(cfg, EVAL_N)
    if launches != want:
        raise AssertionError(f"train-cli-fused launches {launches}, want {want}")
    steps, evals = rec["train"]["steps"], eval_launches(cfg, EVAL_N)
    phase("train-cli-fused", rows=EVAL_N, steps=steps, loss=rec["train"]["loss"],
          train_seconds=f"{rec['train']['seconds']:.3f}",
          clips_per_s=f"{rec['train']['clips_per_sec']:.1f}", R1=rec["eval"]["R1"],
          mIoU=rec["eval"]["mIoU"], seconds_with_eval=f"{seconds:.2f}",
          temporal_per_step=(launches["fused_temporal_layer"]
                             - evals["fused_temporal_layer"]) // steps,
          temporal_bwd_per_step=launches["fused_temporal_layer_bwd"] // steps,
          temporal_per_eval=evals["fused_temporal_layer"])
    phase("launches", path=f"train-cli fused_temporal epoch ({steps} steps + 1 eval)",
          **launches)
    return launches


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                               np.ascontiguousarray(b).view(np.uint8)))


def memmap_dataset(data: MgsvDataset, data_root: str) -> MgsvDataset:
    """`data`'s rows over numpy memmaps of the same stores."""
    return MgsvDataset(data.index, *(
        PackedFeatureStore(os.path.join(data_root, s), use_native=False)
        for s in ("video_store", "music_store")))


def check_native_io(data_root: str, build_seconds: str, card: str) -> None:
    """The native gather against the numpy memmap gather on the EVAL_N
    generated rows: a B=512 batch's store rows and every row of each store,
    float32 (float16 widened in the copy) and raw, equal bit for bit, and
    the host batch whole; then ms per B=512 host batch (MgsvDataset.gather)
    both ways, GATHER_TURNS turns taken alternately, medians."""
    cfg = Config()
    nat = open_synthetic(data_root, cfg.data)
    mm = memmap_dataset(nat, data_root)
    if not isinstance(nat.video_store.arrays["feats"], native.NativeStore):
        raise AssertionError("the dataset's stores do not gather natively")
    batch_idx = next(epoch_index_batches(len(nat), TRAIN_B, shuffle=True,
                                         seed=cfg.train.seed, epoch=1))[0]
    compared = 0
    for store, rows in (("video_store", nat.video_rows), ("music_store", nat.music_rows)):
        a, b = getattr(nat, store), getattr(mm, store)
        for name in ("feats", "mask"):
            for idx in (rows[batch_idx], np.arange(len(a))):
                for dtype in (np.float32, None):
                    if not same_bits(a.gather(name, idx, dtype), b.gather(name, idx, dtype)):
                        raise AssertionError(f"native gather of {store}/{name} ({dtype}) "
                                             "differs from numpy's")
                    compared += len(idx)
    got, want = nat.gather(batch_idx)[0], mm.gather(batch_idx)[0]
    bad = [k for k in want if not same_bits(got[k], want[k])]
    if bad or got.keys() != want.keys():
        raise AssertionError(f"native host batch differs from the memmap one: {bad}")
    times = {True: [], False: []}
    for turn in range(GATHER_TURNS):
        idx = next(epoch_index_batches(len(nat), TRAIN_B, shuffle=True, seed=cfg.train.seed,
                                       epoch=2 + turn))[0]
        for use_native in ((True, False) if turn % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            (nat if use_native else mm).gather(idx)
            times[use_native].append((time.perf_counter() - t0) * 1e3)
    phase("native-io", build_seconds=build_seconds, rows=EVAL_N, batch=TRAIN_B,
          rows_compared=compared, bitwise_equal=True,
          native_ms=f"{np.median(times[True]):.2f}", numpy_ms=f"{np.median(times[False]):.2f}",
          native_turns_ms=",".join(f"{t:.2f}" for t in times[True]),
          numpy_turns_ms=",".join(f"{t:.2f}" for t in times[False]), card=json.dumps(card))


def check_device_data(device: torch.device, data_root: str, card: str) -> None:
    """DeviceResidentData of the EVAL_N rows: bytes uploaded; every key of
    every resident batch torch.equal to the host pipeline's for the same
    indices (one training epoch at B=512, one evaluation pass at B=40 with
    its padded tail); ms per batch of the device gather (CUDA events) and
    of the host pipeline (host clock over an epoch, ending in a
    synchronize, medians of three)."""
    cfg = Config()
    data = open_synthetic(data_root, cfg.data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resident = DeviceResidentData(data, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    streams = {TRAIN_B: dict(shuffle=True, seed=cfg.train.seed, epoch=1),
               EVAL_B: dict(shuffle=False, drop_last=False)}
    batches = 0
    for bs, kw in streams.items():
        host = list(prefetch_epoch(data, bs, device=device, **kw))
        dev = list(resident.epoch_batches(bs, **kw))
        if len(host) != len(dev):
            raise AssertionError(f"device-data: {len(dev)} batches, host {len(host)}")
        for (hb, hm), (db, dm) in zip(host, dev):
            bad = [k for k in hb if not (db[k].dtype == hb[k].dtype and torch.equal(db[k], hb[k]))]
            if bad or db.keys() != hb.keys() or dm.video_ids != hm.video_ids:
                raise AssertionError(f"resident batch differs from the host pipeline's: {bad}")
            batches += 1
    device_ms, host_ms = {}, {}
    for bs, kw in streams.items():
        idx = torch.from_numpy(next(epoch_index_batches(len(data), bs, **kw))[0]).to(device)
        gather_batch(resident.tree, idx)
        device_ms[bs] = cuda_ms(lambda: gather_batch(resident.tree, idx), 20)
        turns = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = sum(1 for _ in prefetch_epoch(data, bs, device=device, **kw))
            torch.cuda.synchronize()
            turns.append((time.perf_counter() - t0) * 1e3 / n)
        host_ms[bs] = float(np.median(turns))
    phase("device-data", rows=EVAL_N, bytes_uploaded=dataset_device_bytes(data),
          upload_seconds=f"{upload_s:.3f}", batches_compared=batches, torch_equal=True,
          **{f"device_gather_ms_B{bs}": f"{ms:.4f}" for bs, ms in device_ms.items()},
          **{f"host_pipeline_ms_B{bs}": f"{ms:.2f}" for bs, ms in host_ms.items()},
          card=json.dumps(card))


def check_train_cli_host(tmp: str, data_root: str, run_dir: str, record: dict) -> None:
    """`cli.train --train.device_data off` on the train-cli phase's rows:
    fed by the host pipeline, the launches of one epoch, and the same
    history record and `last` weights, bit for bit, as the resident run."""
    cfg = Config()
    out_dir, csv = os.path.join(tmp, "train_host"), os.path.join(data_root, "data.csv")
    reset_counts()
    with host_feeds() as (tr, ev):
        result = train_cli.main(["--train.epochs", "1", "--train.output_dir", out_dir,
                                 "--train.device_data", "off", "--data.train_csv", csv,
                                 "--data.val_csv", csv, "--data.feature_root", data_root])
    launches = read_counts()
    if (tr.call_count, ev.call_count) != (1, 1):
        raise AssertionError(f"train-cli-host: {tr.call_count} training and {ev.call_count} "
                             "evaluation epochs from the host pipeline, want 1 and 1")
    if launches != expected_fit_launches(cfg, EVAL_N):
        raise AssertionError(f"train-cli-host launches {launches}")
    rec = result["history"][0]
    timing = ("seconds", "clips_per_sec")
    strip = lambda r: {k: v for k, v in r["train"].items() if k not in timing}
    if strip(rec) != strip(record) or rec["eval"] != record["eval"]:
        raise AssertionError(f"host and resident records differ: {rec} vs {record}")
    want = CheckpointManager(run_dir).restore("last")["params"]
    got = CheckpointManager(os.path.join(out_dir, cfg.train.name)).restore("last")["params"]
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad or got.keys() != want.keys():
        raise AssertionError(f"host and resident last weights differ: {bad[:5]}")
    phase("train-cli-host", rows=EVAL_N, device_data="off", steps=rec["train"]["steps"],
          loss=rec["train"]["loss"], train_seconds=f"{rec['train']['seconds']:.3f}",
          clips_per_s=f"{rec['train']['clips_per_sec']:.1f}",
          resident_clips_per_s=f"{record['train']['clips_per_sec']:.1f}",
          history_equal=True, last_params_bitwise_equal=len(want))


def independent_accumulation(device: torch.device, cfg: Config, data_root: str) -> dict:
    """The weights of one epoch of cfg (gradient_accumulation_steps k)
    without the optimizer's accumulation: per micro-batch m the port's
    forward and backward with the micro-step generator (seed, m), the
    gradients' running mean acc + (g - acc) / (m % k + 1) (exact in any
    division order at k = 2), and one k = 1 GroupedAdam update from it per
    k micro-batches, over the same horizon in updates."""
    k = cfg.train.gradient_accumulation_steps
    data = DeviceResidentData(open_synthetic(data_root, cfg.data), device)
    model = MaDe(cfg, torch.Generator().manual_seed(cfg.train.seed)).to(device)
    n_micro = data.num_batches(TRAIN_B) * cfg.train.epochs
    opt = GroupedAdam(model, cfg.replace(train=dataclasses.replace(
        cfg.train, gradient_accumulation_steps=1)), n_micro // k)
    params = list(model.parameters())
    acc = [torch.zeros_like(p) for p in params]
    for m, (batch, _) in enumerate(data.epoch_batches(TRAIN_B, shuffle=True,
                                                      seed=cfg.train.seed, epoch=1)):
        for p in params:
            p.grad = None
        out = model(batch["frame_feats"], batch["frame_mask"], batch["segment_feats"],
                    batch["segment_mask"], v_duration=batch["v_duration"],
                    generator=step_generator(cfg.train.seed, m, device))
        total_loss(out, batch["spans_target"], cfg, music_codes=batch["music_codes"])[0].backward()
        n = m % k + 1
        with torch.no_grad():
            for a, p in zip(acc, params):
                a.add_(((p.grad if p.grad is not None else torch.zeros_like(p)) - a) / n)
            if n == k:
                for a, p in zip(acc, params):
                    p.grad = a.clone()
                opt.step()
                for a in acc:
                    a.zero_()
    return {name: t.detach().cpu() for name, t in model.state_dict().items()}


def check_train_accum(device: torch.device, tmp: str, data_root: str) -> None:
    """`cli.train --train.gradient_accumulation_steps 2` on the train-cli
    phase's rows: 4 micro-batches of B=512, 2 updates, one evaluation.  The
    launches of one epoch; its `last` weights equal bit for bit to
    `independent_accumulation`; a run preempted at micro-step 3 (one
    gradient in the accumulator, a `last` save every micro-batch) and
    resumed ends with the uninterrupted run's weights and optimizer state,
    bit for bit; the peak device memory."""
    base = Config()
    cfg = base.replace(train=dataclasses.replace(base.train, epochs=1,
                                                 gradient_accumulation_steps=ACCUM_K))
    csv = os.path.join(data_root, "data.csv")
    args = ["--train.epochs", "1", "--train.gradient_accumulation_steps", str(ACCUM_K),
            "--data.train_csv", csv, "--data.val_csv", csv, "--data.feature_root", data_root]
    full_dir, pre_dir = os.path.join(tmp, "accum"), os.path.join(tmp, "accum_pre")
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    result = train_cli.main([*args, "--train.output_dir", full_dir])
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    if launches != expected_fit_launches(cfg, EVAL_N):
        raise AssertionError(f"train-accum launches {launches}")
    rec = result["history"][0]
    micro = EVAL_N // TRAIN_B
    full = CheckpointManager(os.path.join(full_dir, cfg.train.name)).restore("last")
    opt = full["opt_state"]
    if (rec["train"]["steps"], full["step"], opt["count"], opt["mini_step"]) != (
            micro, micro, micro // ACCUM_K, 0) or not np.isfinite(rec["train"]["loss"]):
        raise AssertionError(f"train-accum: record {rec['train']}, step {full['step']}, "
                             f"count {opt['count']}, mini_step {opt['mini_step']}")
    want = independent_accumulation(device, cfg, data_root)
    bad = [k for k in want if not torch.equal(full["params"][k], want[k])]
    if bad:
        raise AssertionError(f"train-accum differs from the independent accumulation: {bad[:5]}")
    pre = [*args, "--train.output_dir", pre_dir, "--train.checkpoint_every_steps", "1"]
    try:
        train_cli.main([*pre, "--train.abort_at_step", "3"])
        raise AssertionError("train-accum: abort_at_step 3 did not preempt the run")
    except Preempted:
        pass
    mgr = CheckpointManager(os.path.join(pre_dir, cfg.train.name))
    saved = mgr.restore("last")
    if (saved["step"], saved["opt_state"]["mini_step"]) != (3, 1):
        raise AssertionError(f"train-accum: saved at step {saved['step']}, mini_step "
                             f"{saved['opt_state']['mini_step']}")
    train_cli.main([*pre, "--train.resume", "last"])
    resumed = mgr.restore("last")
    bad = [k for k in full["params"] if not torch.equal(resumed["params"][k], full["params"][k])]
    for key in ("mu", "nu", "acc_grads"):
        bad += [f"{key}.{k}" for k in opt[key]
                if not torch.equal(resumed["opt_state"][key][k], opt[key][k])]
    if bad or resumed["step"] != full["step"]:
        raise AssertionError(f"train-accum: the resumed run differs: {bad[:5]}")
    phase("train-accum", k=ACCUM_K, micro_batches=micro, updates=micro // ACCUM_K, B=TRAIN_B,
          loss=rec["train"]["loss"], clips_per_s=f"{rec['train']['clips_per_sec']:.1f}",
          R1=rec["eval"]["R1"], equal_to_independent_accumulation=True,
          resumed_from_micro_step=3, resume_bitwise_equal=True,
          peak_mem_gb=f"{peak / 1e9:.2f}")


RANK_KEYS = ("R1", "R3", "R5", "R10", "R20", "R25", "R50", "R100", "MedianR", "MeanR", "MRR")


def device_busy(fn) -> tuple:
    """(wall s, device busy s) of fn() under torch.profiler, tracing the
    device's activity alone (the host's operators, which
    scripts/profile_eval_cuda.py lists, cost the trace most of its time)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    return wall, busy


def sync_warnings(fn) -> list:
    """The host syncs fn() makes, as torch.cuda.set_sync_debug_mode "warn"
    reports them ("called a synchronizing CUDA operation"; the mode's own
    notice that it is a prototype is not one)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [w for w in caught if "called a synchronizing" in str(w.message)]


def resident_pass_syncs(model, resident: DeviceResidentData, cfg: Config,
                        device: torch.device) -> int:
    """Host syncs while the evaluator's resident pass gathers and steps
    every batch, the padded order sent to the card first, as evaluate
    sends it; a `.item()` is counted first, to show the count sees one."""
    if not sync_warnings(lambda: torch.ones((), device=device).item()):
        raise AssertionError("the sync debug mode did not report a .item()")
    eval_step = make_eval_step(model, cfg)
    bs, n = cfg.train.batch_size_val, len(resident)
    order = np.concatenate([np.arange(n), np.full((-n) % bs, n - 1)])
    chunks = torch.from_numpy(order.reshape(-1, bs)).to(device)
    torch.cuda.synchronize()

    @torch.no_grad()
    def run():
        for idx in chunks:
            eval_step(gather_batch(resident.tree, idx))

    syncs = sync_warnings(run)
    torch.cuda.synchronize()
    if syncs:
        raise AssertionError(f"the resident pass waited on the card {len(syncs)} times: "
                             f"{syncs[0].message}")
    return len(syncs)


def check_evaluate_cli(device: torch.device, tmp: str, run_dir: str, data_root: str,
                       record: dict, card: str) -> dict:
    """`cli.evaluate` on the run's best_r1 checkpoint against the trainer's
    record (its split resident through device_data "auto"), then `evaluate`
    with and without kernel #4 on those weights, then on the resident and
    the host path: ranks, IoUs and spans equal exactly, wall times in turns
    and each path's device busy share under the profiler; returns the
    evaluation CLI's launch counts."""
    cfg = Config()
    csv = os.path.join(data_root, "data.csv")
    reset_counts()
    t0 = time.perf_counter()
    with host_feeds() as (_, ev):
        results = evaluate_cli.main(["--ckpt", "best_r1", "--run-dir", run_dir, "--split",
                                     "val", "--data.val_csv", csv, "--data.feature_root",
                                     data_root, "--save-json", os.path.join(tmp, "results.json")])
    cli_s = time.perf_counter() - t0
    launches = read_counts()
    if ev.call_count:
        raise AssertionError("evaluate-cli fed from the host under device_data auto")
    if launches != eval_launches(cfg, EVAL_N):
        raise AssertionError(f"evaluate-cli launches {launches}, want "
                             f"{eval_launches(cfg, EVAL_N)}")
    got, want = results["best_r1"], record["eval"]
    bad = [k for k in RANK_KEYS if got[k] != want[k]]
    if bad or not abs(got["mIoU"] - want["mIoU"]) <= MIOU_ATOL:
        raise AssertionError(f"evaluate-cli metrics differ from the trainer's record: "
                             f"{bad} mIoU {got['mIoU']} vs {want['mIoU']}")
    with open(os.path.join(tmp, "results.json")) as f:
        rows = json.load(f)
    if len(rows) != EVAL_N:
        raise AssertionError(f"--save-json wrote {len(rows)} rows")

    model = MaDe(cfg).to(device).eval()
    model.load_state_dict(CheckpointManager(run_dir).restore("best_r1")["params"])
    data = open_synthetic(data_root, cfg.data)
    runs = {}
    for fused in (True, False):
        t0 = time.perf_counter()
        res = evaluate(model, data, cfg, use_fused_sim=fused)
        torch.cuda.synchronize()
        runs[fused] = (res, time.perf_counter() - t0)
    (fres, fused_s), (pres, plain_s) = runs[True], runs[False]
    sim_err = (fres["sim"] - pres["sim"]).abs().max().item()
    if not sim_err <= KERNEL_ATOL:
        raise AssertionError(f"fused vs plain corpus similarity: {sim_err} > {KERNEL_ATOL}")
    if fres["localization"] != pres["localization"]:
        raise AssertionError("fused and plain evaluations localize differently")
    near = near_tie_rows(fres["sim"], fres["music_ids"], RANK_TIE_ATOL)
    moved = np.flatnonzero(fres["ranks"] != pres["ranks"])
    if not near[moved].all():
        raise AssertionError(f"ranks moved in rows {moved[~near[moved]]} without a near tie")
    phase("evaluate-cli", tag="best_r1", equal_to_trainer_record=True, R1=got["R1"],
          mIoU=got["mIoU"], json_rows=len(rows), cli_seconds=f"{cli_s:.2f}")
    phase("evaluate", rows=EVAL_N, batch=cfg.train.batch_size_val,
          fused_seconds=f"{fused_s:.3f}", plain_seconds=f"{plain_s:.3f}",
          sim_max_abs_err=sim_err, ranks_moved=len(moved),
          near_tie_rows=int(near.sum()), tie_atol=RANK_TIE_ATOL)
    resident = DeviceResidentData(data, device)
    syncs = resident_pass_syncs(model, resident, cfg, device)
    paths = {"resident": resident, "host": data}
    out, walls = {}, {name: [] for name in paths}
    for turn in range(EVAL_TURNS):
        for name in (("host", "resident") if turn % 2 == 0 else ("resident", "host")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = evaluate(model, paths[name], cfg)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    for key in ("ranks", "ious", "pred_spans"):
        if not same_bits(out["resident"][key], out["host"][key]):
            raise AssertionError(f"resident and host evaluations differ in {key}")
    if not torch.equal(out["resident"]["sim"], out["host"]["sim"]):
        raise AssertionError("resident and host evaluations differ in the similarity")
    busy = {name: device_busy(lambda: evaluate(model, d, cfg)) for name, d in paths.items()}
    phase("evaluate", rows=EVAL_N, batch=cfg.train.batch_size_val, turns=EVAL_TURNS,
          resident_median_s=f"{np.median(walls['resident']):.3f}",
          host_median_s=f"{np.median(walls['host']):.3f}",
          resident_s=",".join(f"{t:.3f}" for t in walls["resident"]),
          host_s=",".join(f"{t:.3f}" for t in walls["host"]),
          **{f"{name}_traced_wall_s": f"{w:.3f}" for name, (w, _) in busy.items()},
          **{f"{name}_device_busy_s": f"{b:.3f}" for name, (_, b) in busy.items()},
          **{f"{name}_busy_share": f"{b / w:.3f}" for name, (w, b) in busy.items()},
          ranks_ious_spans_equal=True, resident_batch_syncs=syncs, card=json.dumps(card))
    phase("launches", path="evaluate-cli", **launches)
    return launches


def variant(model_over: dict, loss_over: dict, dtype: str = None) -> Config:
    """Config() with a branch's overrides; dtype, when given, the compute dtype."""
    base = Config()
    model_over = dict(model_over, **({"compute_dtype": dtype} if dtype else {}))
    return base.replace(model=dataclasses.replace(base.model, **model_over),
                        loss=dataclasses.replace(base.loss, **loss_over))


def check_variants(device: torch.device, card: str) -> dict:
    """Each branch of the variant matrix: one float32 step through the
    kernels against the plain steps (float32 and float64, given the kernel
    step's gates at the ReLU sites outside the kernels where rounding can
    turn them: train_runs' share_gates; hold_step: loss, every gradient,
    the launches `per_step` expects), the launch counts the
    branch must show named apart, then a few bf16 steps of the branch
    (finite loss, step ms, peak memory).  Returns {branch: the kernel
    step's launch counts}."""
    launches = {}
    for name, model_over, loss_over, b, fused_decoder in BRANCHES:
        cfg = variant(model_over, loss_over, "float32")
        shapes = []
        hook = lambda model: model.detr_transformer.register_forward_pre_hook(
            lambda mod, args: shapes.append(tuple(args[0].shape)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")       # the fused towers ignore bf16 by design
            runs = train_runs(device, cfg, b, fused_decoder, hook, share_gates=True)
        want = per_step(cfg, fused_decoder)
        loss, worst, worst_plain, n_grads = hold_step(f"variant {name}", runs, want)
        got = runs["launches"]["kernel"]
        m = cfg.model
        named = {   # what each branch must show, apart from per_step's bookkeeping
            "pre_norm": got["fused_encoder_layer"] == got["fused_encoder_layer_bwd"] == 0,
            "xa_music_video": got["xpool_sim_fwd"] == got["xpool_sim_bwd"] == 0,
            "query_xpool": got["xpool_sim_fwd"] == got["xpool_sim_bwd"] == 0,
            "ca": (got["fused_encoder_layer"] == got["fused_encoder_layer_bwd"]
                   == m.detr_enc_layers and shapes[0][1] == Config().data.max_snippet_num),
            "ca_fused_decoder": (got["fused_decoder_layer"] == got["fused_decoder_layer_bwd"]
                                 == m.detr_dec_layers
                                 and shapes[0][1] == Config().data.max_snippet_num),
            "shared_fused_temporal": (got["fused_temporal_layer"]
                                      == got["fused_temporal_layer_bwd"] == 2),
        }
        if not named.get(name, True):
            raise AssertionError(f"variant {name}: launches {got}, DETR input {shapes[0]}")
        launches[name] = got
        phase("variants", branch=name, dtype="float32", B=b, fused_decoder=fused_decoder,
              loss=loss["kernel"], plain_loss=loss["plain"], float64_loss=loss["exact"],
              params=n_grads, grad_max_abs_err=worst, plain_f32_grad_err=worst_plain,
              detr_L=shapes[0][1], gates_turned_plain=runs["flips"]["plain"],
              gates_turned_float64=runs["flips"]["exact"], peak_mem_gb=f"{runs['peak_gb']:.2f}",
              **{k: v for k, v in got.items() if v})
        del runs
        torch.cuda.empty_cache()

        cfg16 = variant(model_over, loss_over)
        batch = to_tensors(example_batch(np.random.RandomState(SEED), cfg16, b), device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, step = train_setup(cfg16, device, fused_decoder=fused_decoder)
            step(batch)                            # first use: allocator, cuBLAS
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            for _ in range(2):
                log = step(batch)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 2 * 1e3
        if not np.isfinite(float(log["loss"])):
            raise AssertionError(f"variant {name}: bf16 step loss {float(log['loss'])}")
        phase("variants", branch=name, dtype="bfloat16", B=b, fused_decoder=fused_decoder,
              loss=float(log["loss"]), step_ms=f"{ms:.2f}",
              peak_mem_gb=f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f}",
              card=json.dumps(card))
        del step, batch, log
        torch.cuda.empty_cache()
    return launches


def check_temporal_shared(device: torch.device) -> list:
    """Kernel #5 as a shared stack runs it: one layer's weights called on
    the audio tower's rows (L=96) and then the video tower's (L=50) at
    B=512, rate 0.8 with a seed each; both outputs and the gradients (the
    weights' summed over both calls, which autograd adds) against the
    plain version and float64; both calls forward, and both backwards,
    timed in turns with the plain version.  Returns the kernels-line
    entries "<kernel>@shared"."""
    cfg = Config()
    m = cfg.model
    d, heads, ffn, rate = m.dim_input, m.temporal_heads, m.temporal_mlp_dim, m.temporal_dropout
    gen = torch.Generator().manual_seed(SEED + 7)
    trm = TemporalTransformer(d, 1, heads, ffn, d)
    trm.reset_parameters(gen)
    layer = perturb_(trm.layers[0], gen).to(device)
    layer64 = copy.deepcopy(layer).double()
    params = list(layer.parameters())
    names = ["x_audio", "x_video"] + [n for n, _ in layer.named_parameters()]
    rng = np.random.default_rng(SEED + 7)
    lengths = (cfg.data.max_snippet_num, cfg.data.max_v_frames)
    xs = [randn(rng, (TRAIN_B, n, d), device) for n in lengths]
    gs = [randn(rng, (TRAIN_B, n, d), device) for n in lengths]
    masks = [torch.from_numpy(ragged_mask(rng, TRAIN_B, n, 1)).to(device) for n in lengths]
    seeds = (DROPOUT_SEED, DROPOUT_SEED + 1)

    def both(fn, lay, dt, grad: bool):
        ins = [x.detach().to(dt).requires_grad_(grad) for x in xs]
        outs = [fn(x, mk.to(dt), lay, rate, sd) for x, mk, sd in zip(ins, masks, seeds)]
        return ins, outs

    outs, grads = {}, {}
    for kind, fn, lay, dt in (("kernel", ftl.fused_temporal_layer, layer, torch.float32),
                              ("plain", ftl.fused_temporal_layer_reference, layer,
                               torch.float32),
                              ("exact", ftl.fused_temporal_layer_reference, layer64,
                               torch.float64)):
        reset_counts()
        ins, o = both(fn, lay, dt, True)
        grads[kind] = torch.autograd.grad(o, [*ins, *lay.parameters()],
                                          [g.to(dt) for g in gs])
        outs[kind] = [t.detach() for t in o]
        if kind == "kernel":
            counts = read_counts()
        del o, ins
    torch.cuda.synchronize()
    if not counts["fused_temporal_layer"] == counts["fused_temporal_layer_bwd"] == 2:
        raise AssertionError(f"shared #5: launches {counts}")
    err = max(check_close(f"fused_temporal_layer shared L={n}", k, p)
              for n, k, p in zip(lengths, outs["kernel"], outs["plain"]))
    gerr, perr, gname, gmax = check_grads("fused_temporal_layer_bwd shared", names,
                                          grads["kernel"], grads["plain"], grads["exact"])
    del outs, grads
    with torch.no_grad():
        ms, plain_ms = in_turns(lambda: both(ftl.fused_temporal_layer, layer, torch.float32,
                                             False),
                                lambda: both(ftl.fused_temporal_layer_reference, layer,
                                             torch.float32, False))
    graphs = {}
    for kind, fn in (("kernel", ftl.fused_temporal_layer),
                     ("plain", ftl.fused_temporal_layer_reference)):
        ins, o = both(fn, layer, torch.float32, True)
        graphs[kind] = (ins, o)
    grad_of = lambda kind: lambda: torch.autograd.grad(
        graphs[kind][1], [*graphs[kind][0], *params], gs, retain_graph=True)
    bms, plain_bms = in_turns(grad_of("kernel"), grad_of("plain"))
    del graphs
    flops = sum(temporal_flops(TRAIN_B, n, d, ffn) for n in lengths)
    fwd_bytes = nbytes(*xs, *masks, *xs, *params)
    bwd_bytes = nbytes(*xs, *masks, *gs, *params, *xs, *params)
    src = "mgsv_tpu_torch/csrc/fused_temporal_layer"
    entries = [
        entry("fused_temporal_layer@shared", f"{src}.cu",
              "mgsv_tpu/ops/pallas/fused_temporal_layer.py:349", err, ms, plain_ms, flops,
              fwd_bytes),
        entry("fused_temporal_layer_bwd@shared", f"{src}_bwd.cu",
              "mgsv_tpu/ops/pallas/fused_temporal_layer.py:381", gerr, bms, plain_bms,
              2 * flops, bwd_bytes)]
    for e in entries:
        e["shape"] = f"B={TRAIN_B} L={lengths[0]} then L={lengths[1]}, one set of weights"
        phase("temporal-kernel", name=e["name"], calls=2, rate=rate, max_abs_err=e["max_abs_err"],
              ms=f"{e['ms']:.4f}", plain_ms=f"{e['plain_ms']:.4f}",
              bound_ms=f"{e['bound_ms']:.4f}", bound_by=e["bound_by"])
    phase("temporal-kernel", name="fused_temporal_layer_bwd@shared", at=gname, its_max=gmax,
          plain_f32_err=perr, rtol_of_max=GRAD_RTOL)
    return entries


def check_variant_clis(device: torch.device, tmp: str) -> None:
    """`cli.train` for one epoch of VARIANT_N generated rows (2 steps at
    B=512, then an evaluation at B=40) with the CA fusion and with the
    pre-norm DETR, each run's launches as `expected_fit_launches` says, and
    `cli.evaluate` on its best_r1 checkpoint equal to the trainer's record;
    then a pre-norm RetrievalEngine on the card (which must not take the
    encoder-layer kernel) against the plain engine, and the engine's
    refusal of a CA model."""
    root = None
    for name, model_over in (("ca", dict(mml_fusion="CA")),
                             ("pre_norm", dict(detr_pre_norm=True))):
        cfg = variant(model_over, {})
        over = [a for k, v in model_over.items() for a in (f"--model.{k}", json.dumps(v))]
        out_dir = os.path.join(tmp, f"variant_{name}")
        data = (["--synthetic", str(VARIANT_N)] if root is None else
                ["--data.train_csv", os.path.join(root, "data.csv"),
                 "--data.val_csv", os.path.join(root, "data.csv"), "--data.feature_root", root])
        reset_counts()
        t0 = time.perf_counter()
        result = train_cli.main(["--train.epochs", "1", "--train.output_dir", out_dir,
                                 *data, *over])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        root = root or os.path.join(out_dir, "synthetic_data")
        rec = result["history"][0]
        if len(result["history"]) != 1 or not np.isfinite(rec["train"]["loss"]):
            raise AssertionError(f"variant cli.train {name}: {result['history']}")
        if launches != expected_fit_launches(cfg, VARIANT_N):
            raise AssertionError(f"variant cli.train {name}: launches {launches}, want "
                                 f"{expected_fit_launches(cfg, VARIANT_N)}")
        run_dir = os.path.join(out_dir, cfg.train.name)
        reset_counts()
        results = evaluate_cli.main(["--ckpt", "best_r1", "--run-dir", run_dir, "--split", "val",
                                     "--data.val_csv", os.path.join(root, "data.csv"),
                                     "--data.feature_root", root, *over])
        eval_counts = read_counts()
        got, want = results["best_r1"], rec["eval"]
        bad = [k for k in RANK_KEYS if got[k] != want[k]]
        if bad or not abs(got["mIoU"] - want["mIoU"]) <= MIOU_ATOL:
            raise AssertionError(f"variant cli.evaluate {name} differs from the trainer's "
                                 f"record: {bad} mIoU {got['mIoU']} vs {want['mIoU']}")
        if eval_counts != eval_launches(cfg, VARIANT_N):
            raise AssertionError(f"variant cli.evaluate {name}: launches {eval_counts}")
        phase("variant-cli", branch=name, rows=VARIANT_N, steps=rec["train"]["steps"],
              loss=rec["train"]["loss"], R1=got["R1"], mIoU=got["mIoU"],
              evaluate_equal_to_record=True, seconds_with_eval=f"{seconds:.2f}",
              **{k: v for k, v in launches.items() if v})

    cfg = variant(dict(detr_pre_norm=True), {}, "float32")
    data_cfg = cfg.data
    rng = np.random.default_rng(SEED + 3)
    model = MaDe(cfg, torch.Generator().manual_seed(SEED)).to(device).eval()
    feats = rng.standard_normal((VARIANT_TRACKS, data_cfg.max_snippet_num, data_cfg.ast_dim),
                                dtype=np.float32)
    index = build_music_index(model, [f"t{i}" for i in range(VARIANT_TRACKS)], feats,
                              ragged_mask(rng, VARIANT_TRACKS, data_cfg.max_snippet_num, 8))
    engine = RetrievalEngine(model, cfg, index)
    if engine.use_fused_kernels:
        raise AssertionError("a pre-norm engine took the post-norm encoder-layer kernel")
    plain = RetrievalEngine(model, cfg, index, use_fused_kernels=False)
    videos = rng.standard_normal((32, data_cfg.max_v_frames, data_cfg.vit_dim),
                                 dtype=np.float32)
    vmask = ragged_mask(rng, 32, data_cfg.max_v_frames, 5)
    for n in (1, 32):
        engine.query(videos[:n], vmask[:n])
        reset_counts()
        res, ms = timed_query(engine, videos[:n], vmask[:n])
        if any(read_counts().values()):
            raise AssertionError(f"the pre-norm engine launched {read_counts()}")
        check_results(res, n, 5, cfg)
        span_err, score_err = compare(res, plain.query(videos[:n], vmask[:n]))
        phase("variant-engine", branch="pre_norm", B=n, top_k=5, dtype="float32",
              ms=f"{ms:.2f}", span_err_s=span_err, score_err=score_err, launches=0)
    ca_cfg = variant(dict(mml_fusion="CA"), {}, "float32")
    try:
        RetrievalEngine(MaDe(ca_cfg).to(device), ca_cfg, index)
    except ValueError as err:
        phase("variant-engine", branch="ca", raised=json.dumps(str(err)))
    else:
        raise AssertionError("RetrievalEngine served a CA model with concat fusion")


def check_temporal_lengths(device: torch.device) -> list:
    """Kernel #5 at the cls token's lengths, L=97 (audio) and L=51 (video):
    one row past the towers' 96 and 50, so each attention sweep's last
    chunk and the saved set's last row tile hold a single row.  Forward and
    backward against the plain version and float64 at B=512, rate 0.8, a
    row with no valid key; the training forward's saved set and the
    backward given it (check_temporal_saved); kernel and plain times in
    turns beside the bound.  Returns the kernels-line entries
    "<kernel>@L<n>"."""
    cfg = Config()
    m = cfg.model
    d, heads, ffn, rate = m.dim_input, m.temporal_heads, m.temporal_mlp_dim, m.temporal_dropout
    gen = torch.Generator().manual_seed(SEED + 9)
    trm = TemporalTransformer(d, 1, heads, ffn, d)
    trm.reset_parameters(gen)
    layer = perturb_(trm.layers[0], gen).to(device)
    layer64 = copy.deepcopy(layer).double()
    params = list(layer.parameters())
    names = ["x"] + [n for n, _ in layer.named_parameters()]
    rng = np.random.default_rng(SEED + 9)
    src = "mgsv_tpu_torch/csrc/fused_temporal_layer"
    entries = []
    for length in (cfg.data.max_snippet_num + 1, cfg.data.max_v_frames + 1):
        x, g = (randn(rng, (TRAIN_B, length, d), device) for _ in range(2))
        mask = torch.from_numpy(ragged_mask(rng, TRAIN_B, length, 1)).to(device)
        mask[-1] = 0.0
        outs, grads = {}, {}
        for kind, fn, lay, dt in (
                ("kernel", ftl.fused_temporal_layer, layer, torch.float32),
                ("plain", ftl.fused_temporal_layer_reference, layer, torch.float32),
                ("exact", ftl.fused_temporal_layer_reference, layer64, torch.float64)):
            xi = x.detach().to(dt).requires_grad_()
            out = fn(xi, mask.to(dt), lay, rate, DROPOUT_SEED)
            grads[kind] = torch.autograd.grad(out, [xi, *lay.parameters()], g.to(dt))
            outs[kind] = out.detach()
            del out
        torch.cuda.synchronize()
        err = check_close(f"fused_temporal_layer L={length}", outs["kernel"], outs["plain"])
        gerr, perr, gname, gmax = check_grads(f"fused_temporal_layer_bwd L={length}", names,
                                              grads["kernel"], grads["plain"], grads["exact"])
        del outs, grads
        with torch.no_grad():
            _, acts = ftl.fused_temporal_layer_fwd(x, mask, layer, rate, DROPOUT_SEED)
        gerr = max(gerr, check_temporal_saved(f"L={length} B={TRAIN_B}", layer, layer64, names,
                                              x, mask, g, rate, acts))
        with torch.no_grad():
            ms, plain_ms = in_turns(
                lambda: ftl.fused_temporal_layer(x, mask, layer, rate, DROPOUT_SEED),
                lambda: ftl.fused_temporal_layer_reference(x, mask, layer, rate, DROPOUT_SEED))
        xi = x.clone().requires_grad_()
        out = ftl.fused_temporal_layer_reference(xi, mask, layer, rate, DROPOUT_SEED)
        bms, plain_bms = in_turns(      # given the saved set, as a training step runs it
            lambda: ftl.fused_temporal_layer_bwd(x, mask, g, layer, rate, DROPOUT_SEED,
                                                 acts=acts),
            lambda: torch.autograd.grad(out, [xi, *params], g, retain_graph=True))
        del out, acts
        flops = temporal_flops(TRAIN_B, length, d, ffn)
        fwd_bytes, bwd_bytes = nbytes(x, mask, x, *params), nbytes(x, mask, g, *params, x, *params)
        for e in (entry(f"fused_temporal_layer@L{length}", f"{src}.cu",
                        "mgsv_tpu/ops/pallas/fused_temporal_layer.py:349", err, ms, plain_ms,
                        flops, fwd_bytes),
                  entry(f"fused_temporal_layer_bwd@L{length}", f"{src}_bwd.cu",
                        "mgsv_tpu/ops/pallas/fused_temporal_layer.py:381", gerr, bms,
                        plain_bms, 2 * flops, bwd_bytes)):
            e["shape"] = f"B={TRAIN_B} L={length} rate={rate}"
            phase("temporal-kernel", name=e["name"], B=TRAIN_B, L=length, rate=rate,
                  max_abs_err=e["max_abs_err"], ms=f"{e['ms']:.4f}",
                  plain_ms=f"{e['plain_ms']:.4f}", bound_ms=f"{e['bound_ms']:.4f}",
                  bound_by=e["bound_by"])
            entries.append(e)
        phase("temporal-kernel", name=f"fused_temporal_layer_bwd@L{length}", at=gname,
              its_max=gmax, plain_f32_err=perr, rtol_of_max=GRAD_RTOL)
        del x, g, mask
    return entries


def aggregator_lengths(model, lengths: list) -> None:
    """Forward pre-hooks recording the sequence length each tower's
    aggregator (temporal stack or EmbeddingNet) is given, video then music."""
    for which, tower in (("video", "video"), ("music", "audio")):
        agg = model.temporal(which)
        if agg is None:
            agg = getattr(model, f"{tower}_embedding_net", None)
        if agg is not None:
            agg.register_forward_pre_hook(lambda mod, args: lengths.append(args[0].shape[1]))


def check_agg_cls(device: torch.device, card: str) -> dict:
    """Each branch of AGG_BRANCHES at B=512: one float32 step through the
    kernels against the plain steps (float32 and float64, the kernel step's
    gates shared at the ReLU sites outside the kernels; hold_step: loss,
    every gradient, the launches `per_step` expects), the EmbeddingNets'
    running buffers after the step against the plain steps' (as gradients
    are held) and moved off their init, and the lengths each tower's
    aggregator sees (one more with the cls token); then bf16 steps of every
    branch and of the default Config(), timed in turns (each, then all in
    reverse): step ms and peak memory.  Returns {branch: the kernel step's
    launch counts}."""
    launches = {}
    data = Config().data
    for name, model_over in AGG_BRANCHES:
        cfg = variant(model_over, {}, "float32")
        extra = int(cfg.model.with_cls_token)
        lengths = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")       # the fused towers ignore bf16 by design
            runs = train_runs(device, cfg, TRAIN_B, False,
                              lambda model: aggregator_lengths(model, lengths), share_gates=True)
        loss, worst, worst_plain, n_grads = hold_step(f"agg-cls {name}", runs, per_step(cfg))
        want_lengths = [data.max_v_frames + extra, data.max_snippet_num + extra]
        if lengths != want_lengths:
            raise AssertionError(f"agg-cls {name}: aggregators given lengths {lengths}, "
                                 f"want {want_lengths}")
        got = runs["launches"]["kernel"]
        if name == "cls_fused_temporal" and not (
                got["fused_temporal_layer"] == got["fused_temporal_layer_bwd"] == 2):
            raise AssertionError(f"agg-cls {name}: launches {got}")
        bufs = runs["buffers"]
        buf_err = 0.0
        if cfg.model.agg_module == "mlp":
            names = sorted(bufs["exact"])
            if len(names) != 8:
                raise AssertionError(f"agg-cls {name}: running buffers {names}")
            buf_err, _, _, _ = check_grads(f"agg-cls {name} running buffers", names,
                                           *([bufs[k][n] for n in names]
                                             for k in ("kernel", "plain", "exact")))
            for n in names:
                init = 0.0 if n.endswith("running_mean") else 1.0
                if torch.equal(bufs["kernel"][n], torch.full_like(bufs["kernel"][n], init)):
                    raise AssertionError(f"agg-cls {name}: {n} did not move")
        launches[name] = got
        phase("agg-cls", branch=name, dtype="float32", B=TRAIN_B, lengths=lengths,
              loss=loss["kernel"], plain_loss=loss["plain"], float64_loss=loss["exact"],
              params=n_grads, grad_max_abs_err=worst, plain_f32_grad_err=worst_plain,
              buffers=len(bufs["kernel"]), buffer_max_abs_err=buf_err,
              gates_turned_plain=runs["flips"]["plain"],
              gates_turned_float64=runs["flips"]["exact"], peak_mem_gb=f"{runs['peak_gb']:.2f}",
              **{k: v for k, v in got.items() if v})
        del runs
        torch.cuda.empty_cache()

    cfgs = {"default": Config(), **{name: variant(over, {}) for name, over in AGG_BRANCHES}}
    batch = to_tensors(example_batch(np.random.RandomState(SEED), Config(), TRAIN_B), device)
    steps = {}
    for name, cfg in cfgs.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, steps[name] = train_setup(cfg, device)
            steps[name](batch)                    # first use: allocator, cuBLAS
    torch.cuda.synchronize()
    seconds, peak = dict.fromkeys(cfgs, 0.0), dict.fromkeys(cfgs, 0)
    for name in [*cfgs, *reversed(cfgs)]:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        for _ in range(AGG_TIMED_STEPS):
            log = steps[name](batch)
        torch.cuda.synchronize()
        seconds[name] += time.perf_counter() - t0
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated(device))
        if not np.isfinite(float(log["loss"])):
            raise AssertionError(f"agg-cls {name}: bf16 step loss {float(log['loss'])}")
    for name, dt in seconds.items():
        n = 2 * AGG_TIMED_STEPS
        phase("agg-cls", branch=name, dtype="bfloat16", B=TRAIN_B, steps=n,
              step_ms=f"{dt / n * 1e3:.2f}", clips_per_s=f"{TRAIN_B * n / dt:.1f}",
              peak_mem_gb=f"{peak[name] / 1e9:.2f}", card=json.dumps(card))
    del steps, batch, log
    torch.cuda.empty_cache()
    return launches


def run_index_cli(argv: list) -> dict:
    """cli.index in-process; its printed JSON reply."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        index_cli.main(argv)
    return json.loads(out.getvalue())


def check_agg_cls_clis(device: torch.device, tmp: str) -> None:
    """`cli.train` for one epoch of VARIANT_N generated rows (2 bf16 steps
    at B=512, then an evaluation at B=40) with the EmbeddingNet and with the
    cls token, each run's launches as `expected_fit_launches` says, and
    `cli.evaluate` on its best_r1 checkpoint equal to the trainer's record.
    The EmbeddingNet run's checkpoint holds its 8 running buffers, moved
    off their init, and `cli.index build` on it raises the engine's
    ValueError.  The cls run: `cli.index build` and `query --run-dir
    <run> --ckpt last` on the card, the index equal to build_music_index on
    the same checkpoint and the reply to RetrievalEngine.query; then that
    checkpoint in a float32 engine on the encoder-layer kernel against the
    plain engine at B=1 and B=32 (ids, scores, spans; launches read)."""
    root = None
    for name, model_over in (("mlp", dict(agg_module="mlp")),
                             ("cls", dict(with_cls_token=True))):
        cfg = variant(model_over, {})
        over = [a for k, v in model_over.items() for a in (f"--model.{k}", json.dumps(v))]
        out_dir = os.path.join(tmp, f"agg_{name}")
        data = (["--synthetic", str(VARIANT_N)] if root is None else
                ["--data.train_csv", os.path.join(root, "data.csv"),
                 "--data.val_csv", os.path.join(root, "data.csv"), "--data.feature_root", root])
        reset_counts()
        t0 = time.perf_counter()
        result = train_cli.main(["--train.epochs", "1", "--train.output_dir", out_dir,
                                 *data, *over])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        root = root or os.path.join(out_dir, "synthetic_data")
        rec = result["history"][0]
        if len(result["history"]) != 1 or not np.isfinite(rec["train"]["loss"]):
            raise AssertionError(f"agg-cls cli.train {name}: {result['history']}")
        if launches != expected_fit_launches(cfg, VARIANT_N):
            raise AssertionError(f"agg-cls cli.train {name}: launches {launches}, want "
                                 f"{expected_fit_launches(cfg, VARIANT_N)}")
        run_dir = os.path.join(out_dir, cfg.train.name)
        reset_counts()
        results = evaluate_cli.main(["--ckpt", "best_r1", "--run-dir", run_dir, "--split", "val",
                                     "--data.val_csv", os.path.join(root, "data.csv"),
                                     "--data.feature_root", root, *over])
        eval_counts = read_counts()
        got, want = results["best_r1"], rec["eval"]
        bad = [k for k in RANK_KEYS if got[k] != want[k]]
        if bad or not abs(got["mIoU"] - want["mIoU"]) <= MIOU_ATOL:
            raise AssertionError(f"agg-cls cli.evaluate {name} differs from the trainer's "
                                 f"record: {bad} mIoU {got['mIoU']} vs {want['mIoU']}")
        if eval_counts != eval_launches(cfg, VARIANT_N):
            raise AssertionError(f"agg-cls cli.evaluate {name}: launches {eval_counts}")
        phase("agg-cls-cli", branch=name, rows=VARIANT_N, steps=rec["train"]["steps"],
              loss=rec["train"]["loss"], R1=got["R1"], mIoU=got["mIoU"],
              evaluate_equal_to_record=True, seconds_with_eval=f"{seconds:.2f}",
              **{k: v for k, v in launches.items() if v})

        store_dir = os.path.join(root, "music_store")
        ckpt = ["--ckpt", "last", "--run-dir", run_dir]
        index_path = os.path.join(out_dir, "index.npz")
        if name == "mlp":
            saved = CheckpointManager(run_dir).restore("last")["params"]
            init = MaDe(cfg, torch.Generator().manual_seed(cfg.train.seed)).state_dict()
            bufs = [n for n in saved if n.endswith(("running_mean", "running_var"))]
            if len(bufs) != 8 or any(torch.equal(saved[n], init[n]) for n in bufs):
                raise AssertionError(f"agg-cls mlp checkpoint buffers {bufs} not all moved")
            try:
                run_index_cli(["build", *ckpt, "--music-store", store_dir, "--out", index_path,
                               *over])
            except ValueError as err:
                phase("agg-cls-cli", branch=name, checkpoint_buffers_moved=len(bufs),
                      index_build_raised=json.dumps(str(err)))
            else:
                raise AssertionError("cli.index built an index of an agg_module='mlp' model")
            continue

        built = run_index_cli(["build", *ckpt, "--music-store", store_dir, "--out", index_path,
                               *over])
        videos = PackedFeatureStore(os.path.join(root, "video_store"))
        vid = videos.ids[0]
        reply = run_index_cli(["query", *ckpt, "--index", index_path, "--video-store",
                               os.path.join(root, "video_store"), "--video-id", vid, *over])
        model = MaDe(cfg).to(device)
        load_weights(model, "last", run_dir, cfg)
        store = PackedFeatureStore(store_dir)
        rows = np.arange(len(store))
        feats, masks = store.gather("feats", rows), store.gather("mask", rows)
        index = build_music_index(model.eval(), store.ids, feats, masks)
        cli_index = MusicIndex.load(index_path)
        index_err = max(np.abs(getattr(index, f) - getattr(cli_index, f)).max()
                        for f in ("music_embs", "seg_tokens", "seg_masks"))
        if not (built["tracks"] == len(store) and cli_index.music_ids == index.music_ids
                and index_err <= KERNEL_ATOL):
            raise AssertionError(f"agg-cls cls: cli.index build differs from build_music_index "
                                 f"({built['tracks']} tracks, max abs error {index_err})")
        row = videos.rows([vid])
        direct = RetrievalEngine(model, cfg, index).query(videos.gather("feats", row),
                                                         videos.gather("mask", row))
        compare([{k: v for k, v in reply.items() if k != "video_id"}], direct)
        check_results(direct, 1, 5, cfg)

        cfg32 = variant(model_over, {}, "float32")
        model32 = MaDe(cfg32).to(device)
        load_weights(model32, "last", run_dir, cfg32)
        index32 = build_music_index(model32.eval(), store.ids, feats, masks)
        engine = RetrievalEngine(model32, cfg32, index32)
        plain = RetrievalEngine(model32, cfg32, index32, use_fused_kernels=False)
        if not engine.use_fused_kernels:
            raise AssertionError("the cls engine on a CUDA device must take the kernel")
        sel = videos.rows(videos.ids[:32])
        vfeats, vmask = videos.gather("feats", sel), videos.gather("mask", sel)
        for n in (1, 32):
            engine.query(vfeats[:n], vmask[:n])
            plain.query(vfeats[:n], vmask[:n])
            reset_counts()
            res, ms = timed_query(engine, vfeats[:n], vmask[:n])
            counts = read_counts()
            if counts != {**dict.fromkeys(COUNTERS, 0),
                          "fused_encoder_layer": cfg32.model.detr_enc_layers}:
                raise AssertionError(f"agg-cls cls engine launches {counts}")
            check_results(res, n, 5, cfg32)
            plain_res, plain_ms = timed_query(plain, vfeats[:n], vmask[:n])
            span_err, score_err = compare(res, plain_res)
            phase("agg-cls-engine", branch=name, tracks=len(store), B=n, top_k=5,
                  dtype="float32", ms=f"{ms:.2f}", plain_ms=f"{plain_ms:.2f}",
                  span_err_s=span_err, score_err=score_err,
                  fused_encoder_layer=counts["fused_encoder_layer"])
        phase("agg-cls-cli", branch=name, index_tracks=built["tracks"], query_video=vid,
              cli_index_vs_build_err=index_err, cli_query_equals_engine=True)
        del model, model32, engine, plain
        torch.cuda.empty_cache()


def check_eval_q(device: torch.device, data_root: str) -> dict:
    """`evaluate` of the generated rows at Q_MULTI moment queries in float32
    (weights from SEED), with the decoder on #6 and with the plain decoder:
    the same ranks and moments within 1e-4 of max_m_duration (the scale they
    are decoded on), the launches of eval_launches; returns the fused run's
    launch counts."""
    base = Config()
    cfg = multi_query(base, dtype="float32")
    model = MaDe(cfg, torch.Generator().manual_seed(SEED)).to(device).eval()
    data = open_synthetic(data_root, cfg.data)
    runs = {}
    for fused in (True, False):
        reset_counts()
        t0 = time.perf_counter()
        res = evaluate(model, data, cfg, fused_decoder=fused)
        torch.cuda.synchronize()
        runs[fused] = (res, time.perf_counter() - t0, read_counts())
        want = eval_launches(cfg, EVAL_N, fused)
        if runs[fused][2] != want:
            raise AssertionError(f"eval-q launches {runs[fused][2]}, want {want}")
    (fres, fused_s, launches), (pres, plain_s, _) = runs[True], runs[False]
    if not np.array_equal(fres["ranks"], pres["ranks"]):
        raise AssertionError("eval-q: ranks differ between the fused and plain decoder")
    span_err = float(np.abs(fres["pred_spans"] - pres["pred_spans"]).max()
                     / cfg.data.max_m_duration)
    if not span_err <= KERNEL_ATOL:
        raise AssertionError(f"eval-q: moments differ by {span_err} of max_m_duration")
    batches = -(-EVAL_N // cfg.train.batch_size_val)
    phase("eval-q", rows=EVAL_N, batch=cfg.train.batch_size_val, queries=Q_MULTI,
          dtype="float32", fused_seconds=f"{fused_s:.3f}", plain_seconds=f"{plain_s:.3f}",
          moment_max_err_of_duration=span_err, atol=KERNEL_ATOL, R1=fres["retrieval"]["R1"],
          mIoU=fres["localization"]["mIoU"], plain_mIoU=pres["localization"]["mIoU"],
          decoder_per_batch=launches["fused_decoder_layer"] // batches)
    phase("launches", path=f"eval-q fused_decoder ({batches} batches)", **launches)
    return launches


def gate_flip_slack(layer64, grads_of) -> tuple:
    """(the float64 gradients grads_of() returns; per gradient tensor the
    sum over every FFN gate of layer64 within FLIP_EPS of zero of |the
    gradient with that gate flipped - the gradient|; the number of such
    gates).  Past the gate the backward is linear, so the effects of any
    set of flips add up to at most that sum.  A gate is flipped by a
    forward hook that negates linear1's output there with a gradient of 1,
    so the ReLU's gate turns while its value moves by under FLIP_EPS."""
    seen = {}
    hook = layer64.linear1.register_forward_hook(lambda m, i, o: seen.update(z=o.detach()))
    exact = grads_of()
    hook.remove()
    near = torch.nonzero(seen["z"].abs() < FLIP_EPS)
    slack = [torch.zeros_like(e) for e in exact]
    for idx in near:                   # one gate at a time: their effects add
        flip = torch.zeros_like(seen["z"], dtype=torch.bool)
        flip[tuple(idx)] = True
        hook = layer64.linear1.register_forward_hook(
            lambda m, i, o: torch.where(flip, o - 2 * o.detach(), o))
        for s_, a, b in zip(slack, grads_of(), exact):
            s_ += (a - b).abs()
        hook.remove()
    return exact, slack, len(near)


def check_decoder(device: torch.device) -> list:
    """Kernel #6 (forward and backward) against autograd through the plain
    version at B=512, L=152, Q=1 and Q_MULTI queries, self-attention on,
    ragged key masks with a row of one valid key; the training forward's
    saved set against its float64 plain version; the backward given that
    set (what autograd runs) equal to the bit to the backward given the
    forward's memory k|v alone and to the recomputing one, run twice;
    kernel and plain timed in turns, and by kernel name with the launch
    count; then the forward at the evaluation's B=40, Q=1.  Returns the
    kernels-line entries at Q_MULTI, the backward's given the saved set."""
    m = Config().model
    d, heads, ffn = m.dim_input, m.detr_heads, m.detr_ffn_dim
    gen = torch.Generator().manual_seed(SEED + 6)
    layer = DetrDecoderLayer(d, heads, ffn, self_attn=True)
    layer.reset_parameters(gen)
    layer = perturb_(layer, gen).to(device)
    layer64 = copy.deepcopy(layer).double()
    params = list(layer.parameters())
    names = ["tgt", "memory", "pos", "query_pos"] + [n for n, _ in layer.named_parameters()]
    rng = np.random.default_rng(SEED + 6)
    mem, pos = (randn(rng, (TRAIN_B, TRAIN_L, d), device) for _ in range(2))
    mask = torch.from_numpy(ragged_mask(rng, TRAIN_B, TRAIN_L, 1)).to(device)
    mask[-1] = 0.0
    mask[-1, 0] = 1.0                              # one valid key
    entries = None
    for q in (1, Q_MULTI):
        tgt, qpos, g = (randn(rng, (TRAIN_B, q, d), device) for _ in range(3))

        def run(fn, lay, dt):
            ins = [t.detach().to(dt).requires_grad_() for t in (tgt, mem, pos, qpos)]
            out = fn(ins[0], ins[1], mask.to(dt), ins[2], ins[3], lay)
            return out.detach(), torch.autograd.grad(out, [*ins, *lay.parameters()], g.to(dt))

        out_k, grads_k = run(fdl.fused_decoder_layer, layer, torch.float32)
        out_p, grads_p = run(fdl.fused_decoder_layer_reference, layer, torch.float32)
        exact, slack, flips = gate_flip_slack(
            layer64, lambda: run(fdl.fused_decoder_layer_reference, layer64, torch.float64)[1])
        torch.cuda.synchronize()
        err = check_close(f"fused_decoder_layer Q={q}", out_k, out_p)
        gerr, perr, gname, gmax = check_grads(f"fused_decoder_layer_bwd Q={q}", names,
                                              grads_k, grads_p, exact, slack=slack)
        phase("decoder-kernel", name="fused_decoder_layer", B=TRAIN_B, Q=q, L=TRAIN_L,
              max_abs_err=err, atol=KERNEL_ATOL)
        phase("decoder-kernel", name="fused_decoder_layer_bwd", B=TRAIN_B, Q=q, L=TRAIN_L,
              grads=len(names), max_abs_err=gerr, at=gname, its_max=gmax, plain_f32_err=perr,
              rtol_of_max=GRAD_RTOL, gates_within_flip_eps=flips, flip_eps=FLIP_EPS)
        del out_k, out_p, grads_k, grads_p, exact, slack
        with torch.no_grad():
            acts = fdl.fused_decoder_layer_fwd(tgt, mem, mask, pos, qpos, layer)[1]
            _, exact_acts = fdl.decoder_layer_acts_reference(
                *(t.double() for t in (tgt, mem, mask, pos, qpos)), layer64)
        act_err = 0.0
        for name, got, want in zip(fdl.SAVED, acts, exact_acts):
            e = (got.double() - want).abs().max().item()
            if not torch.isfinite(got).all() or not e <= KERNEL_ATOL * max(1.0,
                                                                          want.abs().max().item()):
                raise AssertionError(f"fused_decoder_layer Q={q} saved {name}: max abs error {e}")
            act_err = max(act_err, e)
        del exact_acts
        given = {"saved set": {"acts": acts}, "k|v": {"kv": acts[0]}, "nothing": {},
                 "nothing, again": {}}
        runs = {k: fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer, **kw)
                for k, kw in given.items()}
        flat = {k: [*r[:4], *r[4]] for k, r in runs.items()}
        for k in list(given)[1:]:
            if not all(torch.equal(a, b) for a, b in zip(flat["saved set"], flat[k])):
                raise AssertionError(f"fused_decoder_layer_bwd Q={q}: given the saved set, it "
                                     f"differs from the backward given {k}")
        phase("decoder-kernel", name="fused_decoder_layer_bwd", B=TRAIN_B, Q=q, L=TRAIN_L,
              saved_set_equal_to_kv_and_recompute_bitwise=True, two_recomputes_equal=True,
              saved_set_max_abs_err=act_err,
              saved_set_mbytes=f"{nbytes(*(a for a in acts if a is not None)) / 1e6:.1f}",
              query_side_mbytes=f"{nbytes(*(a for a in acts[1:] if a is not None)) / 1e6:.1f}")
        del runs, flat
        with torch.no_grad():
            ms, plain_ms = in_turns(
                lambda: fdl.fused_decoder_layer(tgt, mem, mask, pos, qpos, layer),
                lambda: fdl.fused_decoder_layer_reference(tgt, mem, mask, pos, qpos, layer))
            train_ms = cuda_ms(lambda: fdl.fused_decoder_layer_fwd(tgt, mem, mask, pos, qpos,
                                                                   layer), 5)
        ins = [t.clone().requires_grad_() for t in (tgt, mem, pos, qpos)]
        out = fdl.fused_decoder_layer_reference(ins[0], ins[1], mask, ins[2], ins[3], layer)
        bms, plain_bms = in_turns(      # given the saved set, as a training step runs it
            lambda: fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer, acts=acts),
            lambda: torch.autograd.grad(out, [*ins, *params], g, retain_graph=True))
        kms = cuda_ms(lambda: fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer,
                                                          kv=acts[0]), 5)
        rms = cuda_ms(lambda: fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer),
                      5)
        del out, ins
        flops = decoder_flops(TRAIN_B, q, TRAIN_L, d, ffn)
        fwd_bytes = nbytes(tgt, qpos, mem, pos, mask, *params, tgt)
        bwd_bytes = nbytes(tgt, qpos, mem, pos, mask, g, *params, tgt, qpos, mem, pos, *params)
        for name, t, pt, fl, nb in (("fused_decoder_layer", ms, plain_ms, flops, fwd_bytes),
                                    ("fused_decoder_layer_bwd", bms, plain_bms, 2 * flops,
                                     bwd_bytes)):
            b_ms, by = bound(fl, nb)
            phase("decoder-kernel-time", name=name, B=TRAIN_B, Q=q, L=TRAIN_L, ms=f"{t:.4f}",
                  plain_ms=f"{pt:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=by,
                  gflop=f"{fl / 1e9:.2f}", mbytes=f"{nb / 1e6:.1f}",
                  tflops=f"{fl / t / 1e9:.1f}",
                  **({"given": "saved set", "given_kv_ms": f"{kms:.4f}",
                      "recomputing_ms": f"{rms:.4f}"} if name.endswith("_bwd")
                     else {"training_forward_ms": f"{train_ms:.4f}"}))
        with torch.no_grad():
            if q == Q_MULTI:
                breakdown("fused_decoder_layer", lambda: fdl.fused_decoder_layer(
                    tgt, mem, mask, pos, qpos, layer), B=TRAIN_B, Q=q)
            breakdown("fused_decoder_layer training", lambda: fdl.fused_decoder_layer_fwd(
                tgt, mem, mask, pos, qpos, layer), B=TRAIN_B, Q=q)
        breakdown("fused_decoder_layer_bwd", lambda: fdl.fused_decoder_layer_bwd(
            tgt, mem, mask, pos, qpos, g, layer, acts=acts), B=TRAIN_B, Q=q, given="saved set")
        if q == Q_MULTI:
            src = "mgsv_tpu_torch/csrc/fused_decoder_layer"
            entries = [
                entry("fused_decoder_layer", f"{src}.cu",
                      "mgsv_tpu/ops/pallas/fused_decoder_layer.py:294", err, ms, plain_ms, flops,
                      fwd_bytes),
                entry("fused_decoder_layer_bwd", f"{src}_bwd.cu",
                      "mgsv_tpu/ops/pallas/fused_decoder_layer.py:329", gerr, bms, plain_bms,
                      2 * flops, bwd_bytes)]
        del tgt, qpos, g, acts

    b, q = EVAL_B, 1                               # the evaluation's shape
    tgt, qpos = (randn(rng, (b, q, d), device) for _ in range(2))
    ins = (tgt, mem[:b], mask[:b], pos[:b], qpos)
    with torch.no_grad():
        err = check_close(f"fused_decoder_layer B={b} Q={q}",
                          fdl.fused_decoder_layer(*ins, layer),
                          fdl.fused_decoder_layer_reference(*ins, layer))
        ms, plain_ms = in_turns(lambda: fdl.fused_decoder_layer(*ins, layer),
                                lambda: fdl.fused_decoder_layer_reference(*ins, layer))
    b_ms, by = bound(decoder_flops(b, q, TRAIN_L, d, ffn),
                     nbytes(tgt, qpos, *ins[1:4], *params, tgt))
    phase("decoder-kernel", name="fused_decoder_layer", B=b, Q=q, L=TRAIN_L, max_abs_err=err,
          atol=KERNEL_ATOL, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}",
          bound_by=by)
    entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"], err)
    return entries


def attention_flops(b: int, h: int, lq: int, lk: int, d: int) -> int:
    """q k^T and p v: the Pallas kernel's cost_estimate without its padding."""
    return 4 * b * h * lq * lk * d


def attention_plain(q, k, v, scale, mask=None, chunk: int = SNIPPETS):
    """The plain version a batch chunk at a time, so its [B, H, L, L]
    float32 scores (6.8 GB for one track's 96 snippets) stay bounded."""
    return torch.cat([fa.flash_attention_reference(
        q[i:i + chunk], k[i:i + chunk], v[i:i + chunk], scale,
        None if mask is None else mask[i:i + chunk]) for i in range(0, q.shape[0], chunk)])


def check_flash(device: torch.device) -> dict:
    """Kernel #7 against its plain version at the towers' shapes, in
    float32 and bf16; kernel, plain and SDPA (unmasked shapes: SDPA gives a
    fully masked row the mean of v, not 0) timed in turns beside the
    bound, with a [breakdown] of the float32 extraction shape and of one
    track in bf16.  Returns the kernels-line entry: float32 at the
    extraction's shape, its bf16_* fields at one track's."""
    rng = np.random.default_rng(SEED + 3)
    scale = HEAD_DIM ** -0.5
    cases = [(SNIPPETS, AST_TOKENS, False, torch.float32),
             (SNIPPETS, AST_TOKENS, False, torch.bfloat16),
             (8, AST_TOKENS, True, torch.float32), (8, AST_TOKENS, True, torch.bfloat16),
             (400, CLIP_TOKENS, False, torch.float32),
             (SNIPPETS * EXTRACT_BATCH // 8, AST_TOKENS, False, torch.float32)]
    out, bf16 = None, None
    for b, length, masked, dtype in cases:
        q, k, v = (randn(rng, (b, AST_HEADS, length, HEAD_DIM), device).to(dtype)
                   for _ in range(3))
        mask = None
        if masked:
            mask = torch.from_numpy(ragged_mask(rng, b, length, 1)).to(device)
            mask[-1] = 0.0                                # a row with no valid key
        with torch.no_grad():
            got = fa.flash_attention(q, k, v, scale, mask)
            want = attention_plain(q, k, v, scale, mask)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            atol = KERNEL_ATOL if dtype == torch.float32 else BF16_ATOL
            if not torch.isfinite(got).all() or not err <= atol:
                raise AssertionError(f"flash_attention {dtype} B={b} L={length} "
                                     f"masked={masked}: max abs error {err} > {atol}")
            if masked and got[-1].any():
                raise AssertionError("flash_attention: a fully masked row is not 0")
            del got, want
            ms, plain_ms = in_turns(lambda: fa.flash_attention(q, k, v, scale, mask),
                                    lambda: attention_plain(q, k, v, scale, mask), iters=3)
            sdpa_ms = None
            if not masked:
                sdpa_ms, _ = in_turns(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                    lambda: fa.flash_attention(q, k, v, scale), iters=3)
        flops = attention_flops(b, AST_HEADS, length, length, HEAD_DIM)
        nb = 4 * nbytes(q)
        peak = PEAK_TF32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        bms, by = bound(flops, nb, peak)
        phase("flash-kernel", name="flash_attention", dtype=str(dtype).split(".")[1], B=b,
              H=AST_HEADS, L=length, masked=masked, max_abs_err=err, atol=atol,
              ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              sdpa_ms="none" if sdpa_ms is None else f"{sdpa_ms:.4f}",
              bound_ms=f"{bms:.4f}", bound_by=by, gflop=f"{flops / 1e9:.1f}",
              tflops=f"{flops / ms / 1e9:.1f}")
        dname = str(dtype).split(".")[1]
        if b == SNIPPETS * EXTRACT_BATCH // 8:
            out = entry("flash_attention", "mgsv_tpu_torch/csrc/flash_attention.cu",
                        "mgsv_tpu/ops/pallas/flash_attention.py:89", err, ms, plain_ms,
                        flops, nb, library_ms=sdpa_ms)
            with torch.no_grad():
                breakdown("flash_attention", lambda: fa.flash_attention(q, k, v, scale),
                          dtype=dname, B=b)
        if b == SNIPPETS and dtype == torch.bfloat16 and not masked:
            bf16 = dict(bf16_max_abs_err=err, bf16_ms=ms, bf16_plain_ms=plain_ms,
                        bf16_bound_ms=bms, bf16_bound_by=by, bf16_library_ms=sdpa_ms,
                        bf16_batch=b)
            with torch.no_grad():
                breakdown("flash_attention", lambda: fa.flash_attention(q, k, v, scale),
                          dtype=dname, B=b)
        del q, k, v, mask
    out.update(bf16)
    return out


EXTRACT_FRAMES = (10, 50, 23, 37, 50, 14, 45, 31)      # JPEGs per video (1 fps)
EXTRACT_TRACKS = ((240.0, 16000), (180.0, 44100), (60.0, 16000), (30.0, 16000))
# A store's float16 feature against a float32 re-encoding: one float16 ulp
# of its magnitude (the store rounds to float16) plus 1e-4 for the two
# float32 encodings (kernel and batch against the plain towers).
STORE_ATOL = 1e-4


def write_raw_media(root: str, rng: np.random.Generator) -> str:
    """Seeded frames, tracks, CSV and full-width checkpoints; returns the CSV."""
    rows = []
    for i, n in enumerate(EXTRACT_FRAMES):
        synthetic_raw.write_frames(os.path.join(root, "frames", f"v{i}"), rng, n)
        secs = EXTRACT_TRACKS[i % len(EXTRACT_TRACKS)][0]
        rows.append({"video_id": f"v{i}", "music_id": f"m{i % len(EXTRACT_TRACKS)}",
                     "video_start": 0.0, "video_end": n - 0.5, "music_start": secs / 4,
                     "music_end": secs / 4 + n - 0.5, "music_total_duration": secs})
    os.makedirs(os.path.join(root, "audio"))
    for j, (secs, sr) in enumerate(EXTRACT_TRACKS):
        synthetic_raw.write_wav(os.path.join(root, "audio", f"m{j}.wav"), rng, secs, sr)
    synthetic_raw.write_csv(os.path.join(root, "data.csv"), rows)
    synthetic_raw.mint_clip_checkpoint(os.path.join(root, "clip.pt"), rng)
    synthetic_raw.mint_ast_checkpoint(os.path.join(root, "ast.pth"), rng)
    return os.path.join(root, "data.csv")


def check_store_against(what: str, stored: np.ndarray, plain: torch.Tensor) -> float:
    plain = plain.float().cpu().numpy()
    err = np.abs(stored.astype(np.float32) - plain)
    ulp = np.spacing(np.abs(plain).astype(np.float16)).astype(np.float32)
    if not np.isfinite(stored).all() or not np.all(err <= ulp + STORE_ATOL):
        raise AssertionError(f"{what}: store vs plain towers, max abs error {err.max()}")
    return float(err.max())


def check_extract(device: torch.device, tmp: str) -> dict:
    """`cli.extract_features` at full width on seeded raw media; returns
    the run's launch counts."""
    cfg = Config().data
    root = os.path.join(tmp, "raw")
    t0 = time.perf_counter()
    csv_path = write_raw_media(root, np.random.default_rng(SEED + 4))
    setup_s = time.perf_counter() - t0
    out = os.path.join(tmp, "features")
    reset_counts()
    t0 = time.perf_counter()
    stats = extract_cli.main(["--csv", csv_path, "--frames-root", os.path.join(root, "frames"),
                              "--audio-root", os.path.join(root, "audio"),
                              "--clip-ckpt", os.path.join(root, "clip.pt"),
                              "--ast-ckpt", os.path.join(root, "ast.pth"), "--out", out,
                              "--batch", str(EXTRACT_BATCH), "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts()
    chunks = -(-len(EXTRACT_TRACKS) // (EXTRACT_BATCH // 8))
    want = dict.fromkeys(COUNTERS, 0)
    want["flash_attention"] = 12 * chunks              # one per AST block per music chunk
    if launches != want:
        raise AssertionError(f"extract launches {launches}, want {want}")

    video = PackedFeatureStore(os.path.join(out, "video_store"), use_native=False)
    music = PackedFeatureStore(os.path.join(out, "music_store"), use_native=False)
    vf, vm = np.asarray(video.arrays["feats"]), np.asarray(video.arrays["mask"])
    mf, mm = np.asarray(music.arrays["feats"]), np.asarray(music.arrays["mask"])
    n_v, n_m = len(EXTRACT_FRAMES), len(EXTRACT_TRACKS)
    if (video.ids != [f"v{i}" for i in range(n_v)] or music.ids != [f"m{j}" for j in range(n_m)]
            or vf.shape != (n_v, cfg.max_v_frames, cfg.vit_dim) or vf.dtype != np.float16
            or mf.shape != (n_m, cfg.max_snippet_num, cfg.ast_dim) or mf.dtype != np.float16
            or vm.dtype != np.uint8 or mm.dtype != np.uint8):
        raise AssertionError(f"stores: {video.ids} {vf.shape} {vf.dtype} / {music.ids} "
                             f"{mf.shape} {mf.dtype}")
    centers = np.arange(0, cfg.max_m_duration, cfg.stride)
    want_vm = [[1] * min(n, cfg.max_v_frames) + [0] * (cfg.max_v_frames - min(n, cfg.max_v_frames))
               for n in EXTRACT_FRAMES]
    want_mm = [(centers <= secs).astype(np.uint8).tolist() for secs, _ in EXTRACT_TRACKS]
    if vm.tolist() != want_vm or mm.tolist() != want_mm:
        raise AssertionError(f"store masks: frames {vm.sum(1)}, snippets {mm.sum(1)}")

    # the first video batch and the 44.1 kHz track again, through the plain towers
    clip = extract_cli._load_clip_tower(os.path.join(root, "clip.pt")).to(device).eval()
    ast = extract_cli._load_ast_encoder(os.path.join(root, "ast.pth"), cfg).to(device).eval()
    frames = np.stack([load_clip_frames(os.path.join(root, "frames", f"v{i}"), 0.0, n - 0.5,
                                        cfg.max_v_frames, cfg.image_resolution)[0]
                       for i, n in enumerate(EXTRACT_FRAMES[:EXTRACT_BATCH])])
    wav, sr = load_wav(os.path.join(root, "audio", "m1.wav"))
    specs, _ = extract_snippets(resample_sinc(wav, sr, cfg.sample_rate), cfg.sample_rate,
                                cfg.max_m_duration, cfg.stride, cfg.filter_sec, cfg.padding_sec,
                                cfg.mel_bins, cfg.target_length)
    with torch.inference_mode():
        f = torch.from_numpy(frames).to(device)
        plain_v = clip(f.reshape(-1, *f.shape[2:])).reshape(len(frames), cfg.max_v_frames, -1)
        plain_m = ast(torch.from_numpy(specs).to(device))[1]
    v_err = check_store_against("video_store", vf[:len(frames)], plain_v)
    m_err = check_store_against("music_store m1", mf[1], plain_m)
    del clip, ast, f, plain_v, plain_m

    v_s = stats["video_host_seconds"] + stats["video_device_seconds"]
    m_s = stats["music_host_seconds"] + stats["music_device_seconds"]
    phase("extract", videos=n_v, frames=int(vm.sum()), tracks=n_m, snippets=int(mm.sum()),
          batch=EXTRACT_BATCH, videos_per_s=f"{n_v / v_s:.2f}", tracks_per_s=f"{n_m / m_s:.3f}",
          video_host_s=f"{stats['video_host_seconds']:.3f}",
          video_device_s=f"{stats['video_device_seconds']:.3f}",
          music_host_s=f"{stats['music_host_seconds']:.3f}",
          music_device_s=f"{stats['music_device_seconds']:.3f}",
          cli_seconds=f"{cli_s:.2f}", media_and_checkpoints_seconds=f"{setup_s:.2f}",
          video_vs_plain_err=v_err, music_vs_plain_err=m_err,
          tol="float16 ulp + " + str(STORE_ATOL))
    phase("launches", path=f"extract ({chunks} music chunk(s) of {EXTRACT_BATCH // 8} tracks)",
          **launches)
    return launches


def near_tie_rows(sim: torch.Tensor, music_ids, atol: float) -> np.ndarray:
    """[N] bool: rows where some other track's similarity lies within atol
    of the GT track's best (the similarity that ranks the GT)."""
    codes = torch.as_tensor(np.unique(np.asarray(music_ids), return_inverse=True)[1],
                            device=sim.device)
    same = codes[:, None] == codes[None, :]
    gt_best = torch.where(same, sim, torch.full_like(sim, float("-inf"))).amax(dim=1)
    gap = torch.where(same, torch.full_like(sim, float("inf")), (sim - gt_best[:, None]).abs())
    return (gap.amin(dim=1) <= atol).cpu().numpy()


def no_dropout(cfg: Config) -> Config:
    return cfg.replace(model=dataclasses.replace(cfg.model, temporal_dropout=0.0,
                                                 xpool_dropout=0.0, detr_dropout=0.0,
                                                 ca_dropout=0.0))


def ddp_config(rates: bool) -> Config:
    """Config() in float32, at its dropout rates or at 0."""
    base = Config()
    cfg = base.replace(model=dataclasses.replace(base.model, compute_dtype="float32"))
    return cfg if rates else no_dropout(cfg)


def timed_steps(step, batch, n: int) -> list:
    """ms of each of n steps (host clock around a step that ends in a
    synchronize)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def rank_steps(spec: dict, mesh, device: torch.device) -> tuple:
    """This rank's rows of the held step (the one-process kernel step's
    gates, spec["gates"]), timed steps, and a step at the configured rates
    from the same weights: ({"launches", "flips", "logs", "step_ms",
    "rates_launches"}, the held step's gradients on the device, the
    weights after the rate step on the host)."""
    out = {}
    cfg = ddp_config(rates=False)
    model = MaDe(cfg, torch.Generator().manual_seed(SEED)).to(device)
    step = make_train_step(model, cfg, make_optimizer(model, cfg, HORIZON, mesh), mesh=mesh)
    batch = to_tensors(example_batch(np.random.RandomState(SEED), cfg, TRAIN_B), device)
    mine = {k: local_rows(v, mesh) for k, v in batch.items()}
    counts = []
    hooks = impose_gates(model, torch.load(spec["gates"], weights_only=True), counts, mesh)
    reset_counts()
    log = step(mine)
    torch.cuda.synchronize()
    out["launches"] = read_counts()
    for h in hooks:
        h.remove()
    out["flips"] = sum(counts)
    out["logs"] = {k: float(v.double().mean()) for k, v in log.items()}
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    out["step_ms"] = timed_steps(step, mine, DDP_TIMED_STEPS)
    del model, step

    cfg = ddp_config(rates=True)
    model = MaDe(cfg, torch.Generator().manual_seed(SEED)).to(device)
    step = make_train_step(model, cfg, make_optimizer(model, cfg, HORIZON, mesh), mesh=mesh)
    reset_counts()
    step(mine)
    out["rates_launches"] = read_counts()
    return out, grads, {n: p.detach().cpu() for n, p in model.named_parameters()}


def ddp_rank(spec_path: str, rank: int) -> int:
    """One rank of the ddp phase (`chip_smoke.py --ddp-rank RANK SPEC`):
    joins the group, runs `rank_steps`, timed gradient syncs and an
    evaluation, and writes what the parent compares into the spec's
    directory."""
    with open(spec_path) as f:
        spec = json.load(f)
    dist.initialize(spec["coordinator"], spec["world"], rank, "cuda")
    mesh = make_mesh()
    device = resolve_device(dist.rank_device("cuda"))
    out = {"rank": rank, "backend": torch.distributed.get_backend()}
    steps, grads, params = rank_steps(spec, mesh, device)
    out.update(steps)
    flat = [g.clone() for g in grads.values()]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync_ms = []
    for _ in range(SYNC_REPS):
        dist.barrier("sync-timing")
        start.record()
        out["sync_bytes"] = sync_gradients(flat, mesh)
        end.record()
        torch.cuda.synchronize()
        sync_ms.append(start.elapsed_time(end))
    out["sync_ms"] = sync_ms
    del flat

    cfg = ddp_config(rates=True)
    model = MaDe(cfg, torch.Generator().manual_seed(SEED)).to(device).eval()
    data = DeviceResidentData(open_synthetic(spec["data"], cfg.data), device, mesh)
    # the split tables' batch assembly (one reduce-scatter) at the training
    # and the evaluation batch
    for b in (TRAIN_B, 40):
        idx = torch.arange(b, device=device)
        data.batch(idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SYNC_REPS):
            data.batch(idx)
        torch.cuda.synchronize()
        out[f"gather_ms_B{b}"] = (time.perf_counter() - t0) * 1e3 / SYNC_REPS
    reset_counts()
    res = evaluate(model, data, cfg, mesh=mesh)
    torch.cuda.synchronize()
    out["eval_launches"] = read_counts()
    out["eval"] = {k: res["retrieval"][k] for k in RANK_KEYS}
    torch.save({"grads": {n: g.cpu() for n, g in grads.items()}, "params": params,
                "ranks": torch.as_tensor(np.asarray(res["ranks"])),
                "ious": torch.from_numpy(res["ious"]),
                "sim": res["sim"].cpu() if rank == 0 else None},
               os.path.join(spec["dir"], f"rank{rank}.pt"))
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(argv_of, what: str, log_dir: str, world: int = DDP_RANKS) -> list:
    """Start `world` processes (argv_of(rank)) and wait for all; each one's
    output goes to a file, whose end is raised with a rank that fails.
    Returns each rank's stdout."""
    procs, logs = [], []
    for r in range(world):
        logs.append(open(os.path.join(log_dir, f"{what}.rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(argv_of(r), stdout=logs[-1], stderr=subprocess.STDOUT,
                                      text=True))
    try:
        for p in procs:
            p.wait(timeout=DDP_RANK_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        outs.append(f.read())
        f.close()
        if p.returncode != 0:
            raise AssertionError(f"{what} rank {r} exited {p.returncode}:\n{outs[-1][-4000:]}")
    return outs


def coordinator_args(rank: int, port: int) -> list:
    return ["--coordinator", f"localhost:{port}", "--num-processes", str(DDP_RANKS),
            "--process-id", str(rank)]


def check_ddp(device: torch.device, card: str, tmp: str) -> dict:
    """Phase 23 (module docstring), its files under `tmp`; returns the
    one-process steps (train_runs) whose gates are saved at tmp/gates.pt."""
    t0 = time.perf_counter()
    cfg = ddp_config(rates=False)
    runs = train_runs(device, cfg, TRAIN_B, share_gates=True)
    gates = os.path.join(tmp, "gates.pt")
    torch.save({n: [g.cpu() for g in calls] for n, calls in runs["gates"].items()}, gates)
    model, step = train_setup(cfg, device)
    one_ms = timed_steps(step, runs["batch"], DDP_TIMED_STEPS + 1)[1:]
    del model, step
    data = os.path.join(tmp, "data")
    synthetic.generate(data, n_rows=EVAL_N, data_cfg=Config().data)
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"coordinator": f"localhost:{free_port()}", "world": DDP_RANKS,
                   "gates": gates, "data": data, "dir": tmp}, f)
    t_ranks = time.perf_counter()
    run_ranks(lambda r: [sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r),
                         spec], "ddp", tmp)
    rank_s = time.perf_counter() - t_ranks
    info = []
    for r in range(DDP_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            info.append(json.load(f))
    saved = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
             for r in range(DDP_RANKS)]

    # the held step: rank 0's loss and synchronized gradients in the kernel run's place
    held = dict(runs, logs={**runs["logs"], "kernel": info[0]["logs"]},
                grads={**runs["grads"], "kernel": {n: g.to(device) for n, g in
                                                   saved[0]["grads"].items()}},
                launches={**runs["launches"], "kernel": info[0]["launches"]})
    loss, worst, worst_plain, n_grads = hold_step("ddp step", held, per_step(cfg))
    one = runs["grads"]["kernel"]
    vs_one = max((saved[0]["grads"][n].to(device) - g).abs().max().item()
                 for n, g in one.items())
    for r in range(1, DDP_RANKS):
        if info[r]["launches"] != info[0]["launches"]:
            raise AssertionError(f"ddp: rank launches differ: {info}")
        for key in ("grads", "params"):
            for n, t in saved[0][key].items():
                if not torch.equal(t, saved[r][key][n]):
                    raise AssertionError(f"ddp: rank {r}'s {key} {n} differ from rank 0's")
    for r in range(DDP_RANKS):
        launched = info[r]["launches"]
        phase("ddp", rank=r, backend=info[r]["backend"], rows=TRAIN_B // DDP_RANKS,
              fused_encoder_layer=launched["fused_encoder_layer"],
              fused_encoder_layer_bwd=launched["fused_encoder_layer_bwd"],
              xpool_sim_fwd=launched["xpool_sim_fwd"],
              xpool_sim_bwd=launched["xpool_sim_bwd"],
              xpool_sim_eval=info[r]["eval_launches"]["xpool_sim_eval"],
              gates_turned=info[r]["flips"],
              step_ms=",".join(f"{t:.2f}" for t in info[r]["step_ms"]),
              sync_ms=",".join(f"{t:.3f}" for t in info[r]["sync_ms"]),
              sync_mb=f"{info[r]['sync_bytes'] / 1e6:.3f}",
              split_gather_ms_B512=f"{info[r]['gather_ms_B512']:.2f}",
              split_gather_ms_B40=f"{info[r]['gather_ms_B40']:.2f}", card=json.dumps(card))
        if info[r]["rates_launches"] != per_step(ddp_config(rates=True)):
            raise AssertionError(f"ddp: rank {r} step at the rates launched "
                                 f"{info[r]['rates_launches']}")
        if not info[r]["eval_launches"]["xpool_sim_eval"] >= 1:
            raise AssertionError(f"ddp: rank {r}'s evaluation never launched #4")
    phase("ddp", dtype="float32", B=TRAIN_B, ranks=DDP_RANKS, loss=loss["kernel"],
          one_process_loss=runs["logs"]["kernel"]["loss"], plain_loss=loss["plain"],
          float64_loss=loss["exact"], params=n_grads, grad_max_abs_err=worst,
          plain_f32_grad_err=worst_plain, grad_vs_one_process_kernel=vs_one,
          gates_turned_plain=runs["flips"]["plain"],
          gates_turned_float64=runs["flips"]["exact"],
          ranks_bitwise_equal_grads_and_rate_step_weights=True,
          one_process_step_ms=",".join(f"{t:.2f}" for t in one_ms),
          rank_job_seconds=f"{rank_s:.2f}", card=json.dumps(card))

    # the evaluation split over the ranks against one process's whole #4
    ecfg = ddp_config(rates=True)
    emodel = MaDe(ecfg, torch.Generator().manual_seed(SEED)).to(device).eval()
    res = evaluate(emodel, DeviceResidentData(open_synthetic(data, ecfg.data), device),
                   ecfg)
    sim_err = (saved[0]["sim"].to(device) - res["sim"]).abs().max().item()
    moved = saved[0]["ranks"].numpy() != np.asarray(res["ranks"])
    ties = near_tie_rows(res["sim"], res["music_ids"], 2e-4)
    if not sim_err <= 1e-4 or (moved & ~ties).any():
        raise AssertionError(f"ddp evaluate: sim error {sim_err}, ranks moved off near "
                             f"ties {int((moved & ~ties).sum())}")
    if not all(torch.equal(saved[0][k], saved[r][k]) for r in range(1, DDP_RANKS)
               for k in ("ranks", "ious")):
        raise AssertionError("ddp evaluate: ranks differ between ranks")
    phase("ddp-eval", rows=EVAL_N, ranks=DDP_RANKS, sim_max_abs_err=sim_err,
          ranks_moved=int(moved.sum()), near_tie_rows=int(ties.sum()),
          R1=info[0]["eval"]["R1"], one_process_R1=res["retrieval"]["R1"])
    del emodel, res

    check_nccl_world_of_one(device)
    check_ddp_clis(tmp)
    phase("ddp", seconds=f"{time.perf_counter() - t0:.2f}")
    del runs["gates"]
    return runs


def check_nccl_world_of_one(device: torch.device) -> None:
    """The step at the configured rates in a world of one over NCCL, with
    its mesh, against the same step without a group: loss, gradients and
    weights bit for bit."""
    cfg = ddp_config(rates=True)
    batch = to_tensors(example_batch(np.random.RandomState(SEED), cfg, TRAIN_B), device)
    results = {}
    dist.initialize(f"localhost:{free_port()}", 1, 0, "cuda")
    try:
        backend = torch.distributed.get_backend()
        for mesh in (make_mesh(), None):
            model = MaDe(cfg, torch.Generator().manual_seed(SEED)).to(device)
            step = make_train_step(model, cfg, make_optimizer(model, cfg, HORIZON, mesh),
                                   mesh=mesh)
            log = step(batch)
            results[mesh is None] = (
                log["loss"].clone(), {n: p.grad.clone() for n, p in model.named_parameters()
                                      if p.grad is not None},
                {n: p.detach().clone() for n, p in model.named_parameters()})
            del model, step
    finally:
        dist.shutdown()
    (l1, g1, p1), (l0, g0, p0) = results[False], results[True]
    same = (torch.equal(l1, l0) and g1.keys() == g0.keys()
            and all(torch.equal(g1[n], g0[n]) for n in g0)
            and all(torch.equal(p1[n], p0[n]) for n in p0))
    if backend != "nccl" or not same:
        raise AssertionError(f"ddp world of one over {backend}: the step differs from the "
                             "step without a group")
    phase("ddp-nccl", world=1, backend=backend, dtype="float32", B=TRAIN_B,
          loss=float(l1), bitwise_equal_to_no_group=True)


def check_ddp_clis(tmp: str) -> None:
    """`cli.train` on 2 ranks against one process (float32, dropout 0, one
    epoch of EVAL_N generated rows), then `cli.evaluate` on 2 ranks against
    one process on its best_r1 checkpoint."""
    args = ["--synthetic", str(EVAL_N), "--train.epochs", "1", "--model.compute_dtype",
            "float32", "--model.temporal_dropout", "0.0", "--model.xpool_dropout", "0.0",
            "--model.detr_dropout", "0.0"]
    multi, single = os.path.join(tmp, "cli2"), os.path.join(tmp, "cli1")
    port = free_port()
    t0 = time.perf_counter()
    outs = run_ranks(lambda r: [sys.executable, "-m", "mgsv_tpu_torch.cli.train", *args,
                                "--train.output_dir", multi, *coordinator_args(r, port)],
                     "ddp-train-cli", tmp)
    multi_s = time.perf_counter() - t0
    digests = [json.loads(re.search(r"^MP_RESULT (.*)$", o, re.M).group(1)) for o in outs]
    if [d.pop("process") for d in digests] != list(range(DDP_RANKS)) or any(
            d != digests[0] for d in digests):
        raise AssertionError(f"ddp train-cli: MP_RESULT lines differ: {digests}")
    train_cli.main([*args, "--train.output_dir", single])
    recs = []
    for root in (multi, single):
        with open(os.path.join(root, Config().train.name, "history.json")) as f:
            recs.append(json.load(f)[0])
    got, want = recs
    if not (abs(got["train"]["loss"] - want["train"]["loss"])
            <= DDP_LOSS_RTOL * abs(want["train"]["loss"])
            and all(abs(got["eval"][k] - want["eval"][k]) <= DDP_RECALL_ATOL
                    for k in ("R1", "R5", "R10"))
            and abs(got["eval"]["mIoU"] - want["eval"]["mIoU"]) <= DDP_MIOU_ATOL):
        raise AssertionError(f"ddp train-cli records differ: {got} vs {want}")
    phase("ddp-train-cli", ranks=DDP_RANKS, rows=EVAL_N, dtype="float32", steps=got["train"]["steps"],
          loss=got["train"]["loss"], one_process_loss=want["train"]["loss"],
          R1=got["eval"]["R1"], one_process_R1=want["eval"]["R1"], mIoU=got["eval"]["mIoU"],
          one_process_mIoU=want["eval"]["mIoU"], mp_result_equal=True,
          clips_per_s=f"{got['train']['clips_per_sec']:.1f}",
          one_process_clips_per_s=f"{want['train']['clips_per_sec']:.1f}",
          seconds_with_launch=f"{multi_s:.2f}")

    run_dir = os.path.join(multi, Config().train.name)
    root = os.path.join(multi, "synthetic_data")
    eargs = ["--ckpt", "best_r1", "--run-dir", run_dir, "--split", "val", "--data.val_csv",
             os.path.join(root, "data.csv"), "--data.feature_root", root,
             "--model.compute_dtype", "float32"]
    port = free_port()
    outs = run_ranks(lambda r: [sys.executable, "-m", "mgsv_tpu_torch.cli.evaluate", *eargs,
                                *coordinator_args(r, port)], "ddp-evaluate-cli", tmp)
    evals = [json.loads(re.search(r"^EVAL_RESULT (.*)$", o, re.M).group(1))["results"]
             for o in outs]
    alone = evaluate_cli.main(eargs)["best_r1"]
    got = evals[0]["best_r1"]
    if any(e != evals[0] for e in evals) or any(
            abs(got[k] - alone[k]) > DDP_RECALL_ATOL for k in ("R1", "R5", "R10")) or not abs(
            got["mIoU"] - alone["mIoU"]) <= DDP_MIOU_ATOL:
        raise AssertionError(f"ddp evaluate-cli: {evals} vs one process {alone}")
    phase("ddp-evaluate-cli", ranks=DDP_RANKS, rows=EVAL_N, R1=got["R1"],
          one_process_R1=alone["R1"], mIoU=got["mIoU"], one_process_mIoU=alone["mIoU"],
          equal_across_ranks=True)


def query_p50(engine: RetrievalEngine, feats, mask, reps: int = MA_QUERY_REPS) -> float:
    """The median ms of `reps` queries (host clock; a query ends in a copy
    to the host)."""
    return float(np.median([timed_query(engine, feats, mask)[1] for _ in range(reps)]))


def engine_vs_one(got: list, want: list) -> tuple:
    """A sharded engine's results against the one-process engine's: (ids
    moved off near ties, worst moment error in s, worst score error) over
    the positions whose ids agree.  A position may hold another id where
    the one-process score there lies within RANK_TIE_ATOL of a neighbour's
    (or, at the last position, of the sharded engine's own)."""
    moved, span, score = 0, 0.0, 0.0
    for a, b in zip(got, want):
        ref = np.asarray(b["retrieval_scores"])
        for j, (x, y) in enumerate(zip(a["music_ids"], b["music_ids"])):
            if x != y:
                gaps = [abs(ref[j] - ref[k]) for k in (j - 1, j + 1) if 0 <= k < len(ref)]
                if j == len(ref) - 1:
                    gaps.append(abs(a["retrieval_scores"][j] - ref[j]))
                moved += min(gaps) > RANK_TIE_ATOL
                continue
            span = max(span, float(np.abs(np.subtract(a["moments"][j], b["moments"][j])).max()))
            score = max(score, abs(a["retrieval_scores"][j] - ref[j]),
                        abs(a["moment_scores"][j] - b["moment_scores"][j]))
    return moved, span, score


def similarity_inputs(device: torch.device, cfg: Config) -> tuple:
    """Seeded [EVAL_N, D] video embeddings, [EVAL_N, S, D] snippet tokens
    and ragged masks on the device: the same on every process of a card."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    d, s = cfg.model.dim_input, cfg.data.max_snippet_num
    video = torch.randn(EVAL_N, d, generator=gen, device=device)
    toks = torch.randn(EVAL_N, s, d, generator=gen, device=device)
    lens = torch.randint(8, s + 1, (EVAL_N, 1), generator=gen, device=device)
    return video, toks, (torch.arange(s, device=device) < lens).float()


def model_axis_rank(spec_path: str, rank: int) -> int:
    """One rank of the model-axis phase (`chip_smoke.py --model-axis-rank
    RANK SPEC`).  Job "engine": the index sharded over dp, queries at B=1
    and B=32 (results, #1's launches, the pairs localized, p50).  Job
    "mesh": over (2, 2), the held step and a step at the rates, then an
    evaluation with the plain 2-D similarity and one with #4 split over
    dp, and the plain 2-D similarity of seeded inputs timed alone."""
    with open(spec_path) as f:
        spec = json.load(f)
    dist.initialize(spec["coordinator"], spec["world"], rank, "cuda")
    mesh = make_mesh(spec["mesh_shape"])
    device = resolve_device(dist.rank_device("cuda"))
    out = {"rank": rank, "backend": torch.distributed.get_backend()}
    saved = {}
    if spec["job"] == "engine":
        cfg = ddp_config(rates=True)
        model = MaDe(cfg, torch.Generator().manual_seed(SEED)).to(device).eval()
        z = {k: np.load(os.path.join(spec["dir"], f"{k}.npy"))
             for k in ("music_embs", "seg_tokens", "seg_masks", "videos", "vmask")}
        index = MusicIndex([f"track{i:05d}" for i in range(len(z["music_embs"]))],
                           z["music_embs"], z["seg_tokens"], z["seg_masks"])
        engine = RetrievalEngine(model, cfg, index, mesh=mesh, mesh_axis="dp")
        out["shard_tracks"] = engine._seg_tokens.shape[0]
        pairs = []
        core = engine._localize_core
        engine._localize_core = lambda *a: (pairs.append(a[0].shape[0]), core(*a))[1]
        for b in (1, 32):
            feats, mask = z["videos"][:b], z["vmask"][:b]
            engine.query(feats, mask)                   # first use
            pairs.clear()
            reset_counts()
            out[f"B{b}"] = engine.query(feats, mask)
            out[f"B{b}_launches"] = read_counts()["fused_encoder_layer"]
            out[f"B{b}_pairs"] = sum(pairs)
            out[f"B{b}_p50_ms"] = query_p50(engine, feats, mask)
    else:
        steps, grads, saved["params"] = rank_steps(spec, mesh, device)
        out.update(steps)
        saved["grads"] = {n: g.cpu() for n, g in grads.items()}
        del grads
        cfg = ddp_config(rates=True)
        model = MaDe(cfg, torch.Generator().manual_seed(SEED)).to(device).eval()
        data = DeviceResidentData(open_synthetic(spec["data"], cfg.data), device, mesh)
        for name, fused in (("plain", False), ("fused", True)):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = evaluate(model, data, cfg, mesh=mesh, use_fused_sim=fused)
            torch.cuda.synchronize()
            out[f"{name}_eval_s"] = time.perf_counter() - t0
            out[f"{name}_eval_launches"] = read_counts()
            out[f"{name}_R1"] = res["retrieval"]["R1"]
            saved[f"{name}_ranks"] = torch.as_tensor(np.asarray(res["ranks"]))
            saved[f"{name}_ious"] = torch.from_numpy(res["ious"])
            saved[f"{name}_sim"] = res["sim"].cpu() if rank == 0 else None
        video, toks, mask = similarity_inputs(device, cfg)
        sim_ms = []
        with torch.no_grad():
            for _ in range(MA_SIM_REPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sim = xpool_similarity_mesh(model.xpool, video, toks, mask, mesh)
                torch.cuda.synchronize()
                sim_ms.append((time.perf_counter() - t0) * 1e3)
        out["sim2d_ms"] = sim_ms[1:]
        saved["sim2d"] = sim.cpu() if rank == 0 else None
    torch.save(saved, os.path.join(spec["dir"], f"rank{rank}.pt"))
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown()
    return 0


def model_axis_job(tmp: str, job: str, world: int, mesh_shape, **extra) -> tuple:
    """Run a model-axis job on `world` ranks; (each rank's json, each
    rank's saved tensors, the job's seconds)."""
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"coordinator": f"localhost:{free_port()}", "world": world, "job": job,
                   "mesh_shape": list(mesh_shape), "dir": tmp, **extra}, f)
    t0 = time.perf_counter()
    run_ranks(lambda r: [sys.executable, os.path.abspath(__file__), "--model-axis-rank",
                         str(r), spec], f"model-axis-{job}", tmp, world)
    seconds = time.perf_counter() - t0
    info, saved = [], []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            info.append(json.load(f))
        saved.append(torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True))
    return info, saved, seconds


def check_model_axis_engine(device: torch.device, card: str, tmp: str, index: MusicIndex,
                            videos: np.ndarray, vmask: np.ndarray) -> None:
    """(a) The engine with the 4,096-track index sharded over 2 ranks (dp)
    against the one-process engine, both on #1, at B=1 and B=32."""
    cfg = ddp_config(rates=True)
    for k in ("music_embs", "seg_tokens", "seg_masks"):
        np.save(os.path.join(tmp, f"{k}.npy"), getattr(index, k))
    np.save(os.path.join(tmp, "videos.npy"), videos)
    np.save(os.path.join(tmp, "vmask.npy"), vmask)
    info, _, seconds = model_axis_job(tmp, "engine", MA_ENGINE_RANKS, (MA_ENGINE_RANKS, 1))
    engine = RetrievalEngine(MaDe(cfg, torch.Generator().manual_seed(SEED)).to(device).eval(),
                             cfg, index)
    for b in (1, 32):
        feats, mask = videos[:b], vmask[:b]
        engine.query(feats, mask)
        want = engine.query(feats, mask)
        one_ms = query_p50(engine, feats, mask)
        for r in range(MA_ENGINE_RANKS):
            got = info[r][f"B{b}"]
            check_results(got, b, 5, cfg)
            moved, span, score = engine_vs_one(got, want)
            launched, pairs = info[r][f"B{b}_launches"], info[r][f"B{b}_pairs"]
            if moved or not (span <= SPAN_ATOL_S and score <= SCORE_ATOL):
                raise AssertionError(f"model-axis engine rank {r} B={b}: ids moved off near "
                                     f"ties {moved}, span {span} s, score {score}")
            if launched != (cfg.model.detr_enc_layers if pairs else 0):
                raise AssertionError(f"model-axis engine rank {r} B={b}: #1 launched "
                                     f"{launched} times for {pairs} pairs")
            phase("model-axis", engine_rank=r, backend=info[r]["backend"], B=b, top_k=5,
                  tracks=len(index.music_ids), shard_tracks=info[r]["shard_tracks"],
                  pairs_localized=pairs, fused_encoder_layer=launched,
                  span_err_s=span, score_err=score, ids_moved_off_ties=moved,
                  p50_ms=f"{info[r][f'B{b}_p50_ms']:.2f}", one_process_p50_ms=f"{one_ms:.2f}",
                  card=json.dumps(card))
        if sum(info[r]["B32_launches"] > 0 for r in range(MA_ENGINE_RANKS)) < MA_ENGINE_RANKS:
            raise AssertionError("model-axis engine: a rank localized no pair at B=32")
    phase("model-axis", engine_job_seconds=f"{seconds:.2f}")


def check_model_axis_mesh(device: torch.device, card: str, tmp: str, runs: dict,
                          gates: str, data: str) -> None:
    """(b) 4 ranks at (2, 2): the held step and its bitwise-equal ranks, an
    evaluation with the plain 2-D similarity and one with #4 split over dp,
    against one process."""
    cfg = ddp_config(rates=False)
    info, saved, seconds = model_axis_job(tmp, "mesh", MA_MESH_RANKS, MA_MESH_SHAPE,
                                          gates=gates, data=data)
    held = dict(runs, logs={**runs["logs"], "kernel": info[0]["logs"]},
                grads={**runs["grads"], "kernel": {n: g.to(device) for n, g in
                                                   saved[0]["grads"].items()}},
                launches={**runs["launches"], "kernel": info[0]["launches"]})
    loss, worst, worst_plain, n_grads = hold_step("model-axis step", held, per_step(cfg))
    vs_one = max((saved[0]["grads"][n].to(device) - g).abs().max().item()
                 for n, g in runs["grads"]["kernel"].items())
    for r in range(1, MA_MESH_RANKS):
        if info[r]["launches"] != info[0]["launches"]:
            raise AssertionError(f"model-axis: rank launches differ: {info}")
        for key in ("grads", "params"):
            for n, t in saved[0][key].items():
                if not torch.equal(t, saved[r][key][n]):
                    raise AssertionError(f"model-axis: rank {r}'s {key} {n} differ from rank 0's")
        for key in ("plain_ranks", "plain_ious", "fused_ranks", "fused_ious"):
            if not torch.equal(saved[0][key], saved[r][key]):
                raise AssertionError(f"model-axis: rank {r}'s {key} differ from rank 0's")
    for r in range(MA_MESH_RANKS):
        if info[r]["rates_launches"] != per_step(ddp_config(rates=True)):
            raise AssertionError(f"model-axis: rank {r} step at the rates launched "
                                 f"{info[r]['rates_launches']}")
        phase("model-axis", mesh_rank=r, dp_index=r // MA_MESH_SHAPE[1],
              mp_index=r % MA_MESH_SHAPE[1], backend=info[r]["backend"],
              rows=TRAIN_B // MA_MESH_SHAPE[0], gates_turned=info[r]["flips"],
              fused_encoder_layer=info[r]["launches"]["fused_encoder_layer"],
              fused_encoder_layer_bwd=info[r]["launches"]["fused_encoder_layer_bwd"],
              xpool_sim_fwd=info[r]["launches"]["xpool_sim_fwd"],
              xpool_sim_bwd=info[r]["launches"]["xpool_sim_bwd"],
              xpool_sim_eval=info[r]["fused_eval_launches"]["xpool_sim_eval"],
              plain_eval_xpool_sim_eval=info[r]["plain_eval_launches"]["xpool_sim_eval"],
              step_ms=",".join(f"{t:.2f}" for t in info[r]["step_ms"]),
              plain_eval_s=f"{info[r]['plain_eval_s']:.2f}",
              fused_eval_s=f"{info[r]['fused_eval_s']:.2f}", card=json.dumps(card))
        if info[r]["fused_eval_launches"]["xpool_sim_eval"] < 1 or info[r][
                "plain_eval_launches"]["xpool_sim_eval"]:
            raise AssertionError(f"model-axis: rank {r}'s evaluations launched #4 "
                                 f"{info[r]['fused_eval_launches']['xpool_sim_eval']} and "
                                 f"{info[r]['plain_eval_launches']['xpool_sim_eval']} times")
    phase("model-axis", mesh=json.dumps(list(MA_MESH_SHAPE)), dtype="float32", B=TRAIN_B,
          loss=loss["kernel"], one_process_loss=runs["logs"]["kernel"]["loss"],
          float64_loss=loss["exact"], params=n_grads, grad_max_abs_err=worst,
          plain_f32_grad_err=worst_plain, grad_vs_one_process_kernel=vs_one,
          ranks_bitwise_equal_grads_and_rate_step_weights=True,
          rank_job_seconds=f"{seconds:.2f}", card=json.dumps(card))

    ecfg = ddp_config(rates=True)
    emodel = MaDe(ecfg, torch.Generator().manual_seed(SEED)).to(device).eval()
    resident = DeviceResidentData(open_synthetic(data, ecfg.data), device)
    for name, fused in (("plain", False), ("fused", True)):
        res = evaluate(emodel, resident, ecfg, use_fused_sim=fused)
        sim_err = (saved[0][f"{name}_sim"].to(device) - res["sim"]).abs().max().item()
        moved = saved[0][f"{name}_ranks"].numpy() != np.asarray(res["ranks"])
        ties = near_tie_rows(res["sim"], res["music_ids"], RANK_TIE_ATOL)
        if not sim_err <= 1e-4 or (moved & ~ties).any():
            raise AssertionError(f"model-axis evaluate ({name}): sim error {sim_err}, ranks "
                                 f"moved off near ties {int((moved & ~ties).sum())}")
        phase("model-axis-eval", similarity="2-D plain" if name == "plain" else "#4 over dp",
              rows=EVAL_N, mesh=json.dumps(list(MA_MESH_SHAPE)), sim_max_abs_err=sim_err,
              ranks_moved=int(moved.sum()), near_tie_rows=int(ties.sum()),
              R1=info[0][f"{name}_R1"], one_process_R1=res["retrieval"]["R1"])
    video, toks, mask = similarity_inputs(device, ecfg)
    one_ms = []
    with torch.no_grad():
        for _ in range(MA_SIM_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim = xpool_similarity_blocked(emodel.xpool, video, toks, mask)
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
    sim_err = (saved[0]["sim2d"].to(device) - sim).abs().max().item()
    if not sim_err <= 1e-4:
        raise AssertionError(f"model-axis 2-D similarity: error {sim_err} against one process")
    phase("model-axis-sim", V=EVAL_N, M=EVAL_N, mesh=json.dumps(list(MA_MESH_SHAPE)),
          sim_max_abs_err=sim_err,
          rank_ms=";".join(",".join(f"{t:.2f}" for t in i["sim2d_ms"]) for i in info),
          one_process_blocked_ms=",".join(f"{t:.2f}" for t in one_ms[1:]), card=json.dumps(card))


def check_model_axis(device: torch.device, card: str, tmp: str, runs: dict,
                     index: MusicIndex, videos: np.ndarray, vmask: np.ndarray) -> None:
    """Phase 24 (module docstring); `tmp` holds [ddp]'s gates and data."""
    t0 = time.perf_counter()
    for sub in ("engine", "mesh"):
        os.makedirs(os.path.join(tmp, "model_axis", sub))
    check_model_axis_engine(device, card, os.path.join(tmp, "model_axis", "engine"), index,
                            videos, vmask)
    check_model_axis_mesh(device, card, os.path.join(tmp, "model_axis", "mesh"), runs,
                          os.path.join(tmp, "gates.pt"), os.path.join(tmp, "data"))
    phase("model-axis", seconds=f"{time.perf_counter() - t0:.2f}")


def check_ab(device: torch.device, card: str) -> None:
    """Phase 25 (module docstring): scripts/ab_kernels_cuda.py's fingerprint
    and dropout-off check, each failure raised."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import ab_kernels_cuda as ab

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        a = ab.parse_args(["--device", str(device), "--dropout", "off", "--fingerprint",
                           "--draws", str(AB_DRAWS), "--out", tmp,
                           "--report", os.path.join(tmp, "report.md")])
        cfg = ab.arm_config("plain", ab.base_overrides(a))
        res = ab.run_fingerprint(a, device, ab.make_store(os.path.join(tmp, "fp"), cfg,
                                                          a.fp_rows, a))
        verdict = ab.fingerprint_verdict(res)
        for arm, v in verdict.items():
            counts = {k: sum(res["launches"][(scen, arm)][k] for scen in ab.SCENARIOS)
                      for k in ab.COUNTERS}
            phase("ab", mode="fingerprint", arm=arm, draws=AB_DRAWS, rows=a.fp_rows,
                  none_max_rel=f"{v['none_max_rel']:.3e}", none_rtol=ab.NONE_RTOL,
                  holm="clean" if v["clean"] else "REJECTED:" + ",".join(v["rejected"]),
                  fused_encoder_layer=counts["fused_encoder_layer"],
                  xpool_sim_fwd=counts["xpool_sim_fwd"],
                  fused_temporal_layer=counts["fused_temporal_layer"], card=json.dumps(card))
        if not ab.fingerprint_ok(verdict):
            raise AssertionError(f"ab fingerprint: {verdict}")
        res = ab.run_off(a, device, ab.make_store(os.path.join(tmp, "data"), cfg, a.rows, a),
                         tmp)
    for arm in ab.KERNEL_ARMS:
        r, c = res["arms"][arm], res["launches"][arm]
        phase("ab", mode="dropout-off", arm=arm, steps=a.steps, B=a.bs,
              held_loss_max_rel=f"{r['max_rel']:.3e}", rtol=ab.OFF_RTOL,
              held_grad_norm_max_rel=f"{r['grad_norm_max_rel']:.3e}",
              grad_norm_rtol=ab.GRAD_NORM_RTOL, free_max_rel=f"{r['free_max_rel']:.3e}",
              free_first_over=r["free_first_over"],
              control_first_over=res["arms"]["control"]["free_first_over"],
              fused_encoder_layer=c["fused_encoder_layer"],
              fused_encoder_layer_bwd=c["fused_encoder_layer_bwd"],
              xpool_sim_fwd=c["xpool_sim_fwd"], xpool_sim_bwd=c["xpool_sim_bwd"],
              fused_temporal_layer=c["fused_temporal_layer"],
              fused_temporal_layer_bwd=c["fused_temporal_layer_bwd"], card=json.dumps(card))
    if not ab.off_ok(res):
        raise AssertionError(f"ab dropout off: {res['arms']}")
    phase("ab", seconds=f"{time.perf_counter() - t0:.2f}")


def check_jax_resume(device: torch.device, card: str, tmp: str) -> None:
    """Phase 26 (module docstring): the converted JAX run of JAX_FIXTURE
    resumed by cli.train on the card, held to JAX's resumed run."""
    with open(os.path.join(JAX_FIXTURE, "expected.json")) as f:
        want = json.load(f)
    out = os.path.join(tmp, "jax_resume")
    shutil.copytree(os.path.join(JAX_FIXTURE, "made"), os.path.join(out, "made"))
    losses, make = [], train_loop.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def train_step(batch):
            log = step(batch)
            losses.append(log["loss"].detach())
            return log
        return train_step

    argv = ["--device", str(device), "--synthetic", str(want["synthetic_rows"]),
            *overrides_to_args(want["overrides"]), "--train.output_dir", out, "--train.resume", "last"]
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(train_loop, "make_train_step", recording):
        train_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    got = np.array([float(x) for x in losses])
    exp = np.array(want["resumed_losses"])
    if got.shape != exp.shape:
        raise AssertionError(f"jax-resume: {got.size} resumed steps, JAX took {exp.size}")
    rel = np.abs(got - exp) / np.abs(exp)
    with open(os.path.join(out, "made", "history.json")) as f:
        history = json.load(f)
    hist_rel = [abs(g["train"]["loss"] - e["train"]["loss"]) / abs(e["train"]["loss"])
                for g, e in zip(history, want["resumed_history"])]
    if [r["epoch"] for r in history] != [r["epoch"] for r in want["resumed_history"]]:
        raise AssertionError(f"jax-resume: history epochs {[r['epoch'] for r in history]}")
    if rel.max() > JAX_RESUME_RTOL or max(hist_rel) > JAX_RESUME_RTOL:
        raise AssertionError(f"jax-resume: step losses {got.tolist()} against JAX's "
                             f"{exp.tolist()}, history gaps {hist_rel}")
    path = ("fused_encoder_layer", "fused_encoder_layer_bwd", "xpool_sim_fwd",
            "xpool_sim_bwd", "xpool_sim_eval")
    if not all(launches[k] for k in path):
        raise AssertionError(f"jax-resume did not run every kernel of its path: {launches}")
    phase("jax-resume", steps=got.size, loss_max_rel=f"{rel.max():.3e}",
          history_max_rel=f"{max(hist_rel):.3e}", rtol=JAX_RESUME_RTOL,
          epochs=len(history), seconds=f"{seconds:.2f}", card=json.dumps(card),
          **{k: launches[k] for k in path})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ddp-rank"]:
        return ddp_rank(sys.argv[3], int(sys.argv[2]))
    if sys.argv[1:2] == ["--model-axis-rank"]:
        return model_axis_rank(sys.argv[3], int(sys.argv[2]))
    device = resolve_device("cuda")
    name, card = check_device()
    build_kernels()
    native_seconds = build_native()
    entries = (check_encoder(device) + check_xpool(device) + check_temporal(device)
               + check_decoder(device))
    launches = check_train(device)
    fused_launches = check_train(device, fused_temporal=True)
    q_launches = check_train(device, fused_decoder=True)
    check_timed(device, card)
    engine, videos, vmask = check_slice(device)
    check_http(engine, videos, vmask)
    index = engine.index         # the model-axis phase shards it over 2 ranks
    del engine
    entries.append(check_eval_kernel(device))
    with tempfile.TemporaryDirectory() as tmp:
        run_dir, data_root, record, fit_launches = check_train_cli(tmp)
        check_native_io(data_root, native_seconds, card)
        check_device_data(device, data_root, card)
        check_train_cli_host(tmp, data_root, run_dir, record)
        check_train_cli_fused(tmp, data_root)
        check_train_accum(device, tmp, data_root)
        check_evaluate_cli(device, tmp, run_dir, data_root, record, card)
        check_eval_q(device, data_root)
    t0 = time.perf_counter()
    entries += check_encoder(device, Config().data.max_snippet_num) + check_temporal_shared(device)
    branch_launches = check_variants(device, card)
    with tempfile.TemporaryDirectory() as tmp:
        check_variant_clis(device, tmp)
    phase("variants", branches=len(BRANCHES), seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    entries += check_temporal_lengths(device)
    agg_launches = check_agg_cls(device, card)
    with tempfile.TemporaryDirectory() as tmp:
        check_agg_cls_clis(device, tmp)
    phase("agg-cls", branches=len(AGG_BRANCHES), seconds=f"{time.perf_counter() - t0:.2f}")
    entries.append(check_flash(device))
    with tempfile.TemporaryDirectory() as tmp:
        extract_launches = check_extract(device, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        ddp_runs = check_ddp(device, card, tmp)
        check_model_axis(device, card, tmp, ddp_runs, index, videos, vmask)
    check_ab(device, card)
    with tempfile.TemporaryDirectory() as tmp:
        check_jax_resume(device, card, tmp)
    launches["xpool_sim_eval"] = fit_launches["xpool_sim_eval"]      # per evaluation
    launches["flash_attention"] = extract_launches["flash_attention"]  # per extraction
    for kernel in ("fused_temporal_layer", "fused_temporal_layer_bwd"):  # per fused_temporal step
        launches[kernel] = fused_launches[kernel]
    for kernel in ("fused_decoder_layer", "fused_decoder_layer_bwd"):    # per Q=10 fused step
        launches[kernel] = q_launches[kernel]
    for kernel in ("fused_encoder_layer", "fused_encoder_layer_bwd"):    # per CA step (L=96)
        launches[f"{kernel}@L{Config().data.max_snippet_num}"] = branch_launches["ca"][kernel]
    for kernel in ("fused_temporal_layer", "fused_temporal_layer_bwd"):  # per shared-stack step
        launches[f"{kernel}@shared"] = branch_launches["shared_fused_temporal"][kernel]
    cls_fused = agg_launches["cls_fused_temporal"]
    for kernel in ("fused_temporal_layer", "fused_temporal_layer_bwd"):  # per cls step, a tower each
        for length in (Config().data.max_snippet_num + 1, Config().data.max_v_frames + 1):
            launches[f"{kernel}@L{length}"] = cls_fused[kernel] // 2
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
