"""Smoke run of the PyTorch/CUDA port (mgsv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA device

Drives the port's two paths at the paper widths (Config(): D=256, 50
frames, 96 snippets, 2 DETR encoder / 6 decoder layers, B=512 in training)
with seeded random weights, in phases that each print lines and raise on
failure:

  1. device   card name, and its name and power limit from nvidia-smi
  2. build    compiles the CUDA kernels from mgsv_tpu_torch/csrc, one nvcc
              per source, all started together; registers and spills
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
              parameter's gradient compared; launches per step, the step's
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
              at B=40 (52 batches, one corpus similarity); history.json,
              the best_* and last checkpoints and every launch count read
 12. train-cli-fused  `cli.train --model.fused_temporal true` on the same
              rows: 4 steps and one evaluation, #5's launches per step and
              per evaluation read
 13. evaluate-cli  `cli.evaluate` on that run's best_r1 checkpoint: its
              metrics equal the trainer's record; then `evaluate` with the
              kernel and with the plain corpus similarity on the same
              weights, timed: similarities, localization and ranks compared
 14. eval-q   `evaluate` of the same rows at ten moment queries (float32),
              with the decoder on #6 and without: the same ranks, moments
              within 1e-4 of max_m_duration, six #6 launches per batch
 15. flash-kernel  the attention kernel (#7) against its plain version in
              float32 and bf16: the AST's [96, 12, 1214, 64] (one track),
              [8, 12, 1214, 64] with ragged key masks and a fully masked
              row, CLIP's [400, 12, 50, 64], and the extraction's
              [384, 12, 1214, 64]; kernel, plain and SDPA timed in turns
              beside the bound; [breakdown] lines of the extraction's shape
              (float32) and of one track (bf16)
 16. extract  `cli.extract_features` in-process on seeded raw media (8 frame
              directories of 10-50 JPEGs, WAV tracks of 240/180/60/30 s, one
              at 44.1 kHz) with full-width CLIP ViT-B/32 and AST checkpoints
              minted in the reference layouts: store ids, shapes and masks,
              12 kernel launches per music chunk, one video batch and one
              track encoded again with the plain towers; videos/s, tracks/s,
              host and device seconds

then prints the kernels' JSON line and, last, {"ok": true, "device": ...}.
It exits non-zero, without that last line, when no CUDA device is present
or any phase fails.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import http.client
import json
import os
import re
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
from mgsv_tpu_torch.cli import train as train_cli
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.checkpoint import CheckpointManager
from mgsv_tpu_torch.core.device import resolve_device
from mgsv_tpu_torch.data import synthetic_raw
from mgsv_tpu_torch.data.audio import extract_snippets, resample_sinc
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.data.feature_store import PackedFeatureStore
from mgsv_tpu_torch.data.frames import load_clip_frames
from mgsv_tpu_torch.data.media import load_wav
from mgsv_tpu_torch.data.synthetic import open_synthetic
from mgsv_tpu_torch.eval.evaluator import evaluate
from mgsv_tpu_torch.eval.similarity import (xpool_eval_inputs, xpool_sim_fused,
                                            xpool_similarity_blocked)
from mgsv_tpu_torch.models.detr import DetrDecoderLayer, DetrEncoderLayer
from mgsv_tpu_torch.models.layers import l2_normalize
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.models.temporal import TemporalTransformer
from mgsv_tpu_torch.models.xpool import XPoolTransformer
from mgsv_tpu_torch.ops import lsap
from mgsv_tpu_torch.ops.cuda import flash_attention as fa
from mgsv_tpu_torch.ops.cuda import fused_decoder_layer as fdl
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
from mgsv_tpu_torch.ops.cuda import fused_temporal_layer as ftl
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps
from mgsv_tpu_torch.runtime import kernels
from mgsv_tpu_torch.serve.engine import RetrievalEngine, build_music_index
from mgsv_tpu_torch.train.optimizer import make_optimizer
from mgsv_tpu_torch.train.step import make_train_step

SEED = 0
DROPOUT_SEED = 1234        # the Philox seed of the kernel phases
TRAIN_B = 512              # the paper's training batch
TRAIN_L = 152              # 50 frames + 96 snippets, padded to a multiple of 8
N_TRACKS = 4096            # MGSV-EC's catalog size
EVAL_N = 2048              # corpus of the eval phases: about an MGSV-EC split (2,000)
SERVE_V = 32               # videos of a B=32 serving scan over the N_TRACKS index
SERVE_ROWS = (8, 256)      # fused rows B*k: a B=1 query, and B=32 x k-bucket 8
TIMED_STEPS = 5
Q_MULTI = 10               # moment queries of the multi-query phases
HORIZON = 1000             # schedule length the optimizers are built for
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
    """Launches of one training step: two encoder layers, one X-Pool
    similarity, with fused_temporal each tower's temporal layers, and with
    fused_decoder each decoder layer."""
    temporal = 2 * cfg.model.temporal_depth if cfg.model.fused_temporal else 0
    decoder = cfg.model.detr_dec_layers if fused_decoder else 0
    return {"fused_encoder_layer": cfg.model.detr_enc_layers,
            "fused_encoder_layer_bwd": cfg.model.detr_enc_layers,
            "xpool_sim_fwd": 1, "xpool_sim_bwd": 1, "xpool_sim_eval": 0,
            "flash_attention": 0, "fused_temporal_layer": temporal,
            "fused_temporal_layer_bwd": temporal, "fused_decoder_layer": decoder,
            "fused_decoder_layer_bwd": decoder}


def phase(tag: str, /, **fields) -> None:
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


def check_encoder(device: torch.device) -> list:
    """Kernels #1 (forward) and #2 (backward) against autograd through the
    plain version, at B=512, L=152, rates 0 and the configuration's; then
    both at precision "bf16" (check_encoder_bf16)."""
    m = Config().model
    d, heads, ffn, rate = m.dim_input, m.detr_heads, m.detr_ffn_dim, m.detr_dropout
    gen = torch.Generator().manual_seed(SEED)
    layer = DetrEncoderLayer(d, heads, ffn)
    layer.reset_parameters(gen)
    layer = perturb_(layer, gen).to(device)
    params = list(layer.parameters())
    names = ["x", "pos"] + [n for n, _ in layer.named_parameters()]
    rng = np.random.default_rng(SEED)
    x, pos, g = (randn(rng, (TRAIN_B, TRAIN_L, d), device) for _ in range(3))
    mask = torch.from_numpy(ragged_mask(rng, TRAIN_B, TRAIN_L, 1)).to(device)
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
        gerr, perr, gname, gmax = check_grads(f"fused_encoder_layer_bwd rate {r}", names,
                                              grads["kernel"], grads["plain"], grads["exact"])
        phase("kernel", name="fused_encoder_layer", B=TRAIN_B, L=TRAIN_L, rate=r,
              max_abs_err=err, atol=KERNEL_ATOL)
        phase("kernel", name="fused_encoder_layer_bwd", B=TRAIN_B, L=TRAIN_L, rate=r,
              grads=len(names), max_abs_err=gerr, at=gname, its_max=gmax,
              plain_f32_err=perr, rtol_of_max=GRAD_RTOL)
        fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, gerr)
        del outs, grads
    with torch.no_grad():                 # the serving shapes, rate 0
        for rows in SERVE_ROWS:
            xs, ps = (randn(rng, (rows, TRAIN_L, d), device) for _ in range(2))
            ms_ = torch.from_numpy(ragged_mask(rng, rows, TRAIN_L, 1)).to(device)
            err = check_close(f"fused_encoder_layer rows {rows}",
                              fel.fused_encoder_layer(xs, ms_, ps, layer),
                              fel.fused_encoder_layer_reference(xs, ms_, ps, layer))
            kms, pms = in_turns(lambda: fel.fused_encoder_layer(xs, ms_, ps, layer),
                                lambda: fel.fused_encoder_layer_reference(xs, ms_, ps, layer))
            bms_, by = bound(encoder_flops(rows, TRAIN_L, d, ffn),
                             nbytes(xs, ps, ms_, xs, *params))
            phase("kernel", name="fused_encoder_layer", B=rows, L=TRAIN_L, rate=0.0,
                  max_abs_err=err, atol=KERNEL_ATOL, ms=f"{kms:.4f}", plain_ms=f"{pms:.4f}",
                  bound_ms=f"{bms_:.4f}", bound_by=by)
            fwd_err = max(fwd_err, err)

    with torch.no_grad():
        ms, plain_ms = in_turns(
            lambda: fel.fused_encoder_layer(x, mask, pos, layer, rate, DROPOUT_SEED),
            lambda: fel.fused_encoder_layer_reference(x, mask, pos, layer, rate, DROPOUT_SEED))
    xi, pi = x.clone().requires_grad_(), pos.clone().requires_grad_()
    out = fel.fused_encoder_layer_reference(xi, mask, pi, layer, rate, DROPOUT_SEED)
    bms, plain_bms = in_turns(
        lambda: fel.fused_encoder_layer_bwd(x, mask, pos, g, layer, rate, DROPOUT_SEED),
        lambda: torch.autograd.grad(out, [xi, pi, *params], g, retain_graph=True))
    del out
    phase("kernel-time", name="fused_encoder_layer", B=TRAIN_B, L=TRAIN_L, rate=rate,
          ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    phase("kernel-time", name="fused_encoder_layer_bwd", B=TRAIN_B, L=TRAIN_L, rate=rate,
          ms=f"{bms:.4f}", plain_ms=f"{plain_bms:.4f}")
    with torch.no_grad():
        breakdown("fused_encoder_layer", lambda: fel.fused_encoder_layer(
            x, mask, pos, layer, rate, DROPOUT_SEED), precision="f32")
    breakdown("fused_encoder_layer_bwd", lambda: fel.fused_encoder_layer_bwd(
        x, mask, pos, g, layer, rate, DROPOUT_SEED), precision="f32")
    flops = encoder_flops(TRAIN_B, TRAIN_L, d, ffn)
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
    bf16 = check_encoder_bf16(layer, layer64, names, x, pos, mask, g, rate)
    for e, fl, nb in zip(entries, (flops, 2 * flops), (fwd_bytes, bwd_bytes)):
        err16, ms16, plain16, ms32 = bf16[e["name"]]
        b16, by16 = bound(fl, nb, PEAK_BF16_FLOPS)
        e.update(bf16_max_abs_err=err16, bf16_ms=ms16, bf16_plain_ms=plain16,
                 bf16_bound_ms=b16, bf16_bound_by=by16, f32_ms_in_turns=ms32)
        phase("kernel-time", name=e["name"], precision="bf16", B=TRAIN_B, L=TRAIN_L,
              rate=rate, ms=f"{ms16:.4f}", f32_ms=f"{ms32:.4f}", plain_ms=f"{plain16:.4f}",
              bound_ms=f"{b16:.4f}", bound_by=by16, gflop=f"{fl / 1e9:.1f}",
              tflops=f"{fl / ms16 / 1e9:.1f}")
    return entries


def check_encoder_bf16(layer, layer64, names, x, pos, mask, g, rate) -> dict:
    """Kernels #1 and #2 at precision "bf16" against the bf16 plain version
    (every product's operands rounded to bf16, float32 sums) at rates 0 and
    `rate`: the forward within BF16_ATOL and nearer the bf16 plain output
    than the float32 kernel's, every gradient against the float64 run of the
    same bf16 rounding (BF16_GRAD_RTOL); then each timed in turns with the
    bf16 plain version and with the float32 instantiation.  Returns {name:
    (max abs error, ms, plain ms, float32 ms)}."""
    params = list(layer.parameters())
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
        phase("kernel", name="fused_encoder_layer", precision="bf16", B=TRAIN_B, L=TRAIN_L,
              rate=r, max_abs_err=err, atol=BF16_ATOL, f32_kernel_vs_bf16_plain=f32_gap)
        phase("kernel", name="fused_encoder_layer_bwd", precision="bf16", B=TRAIN_B, L=TRAIN_L,
              rate=r, grads=len(names), max_abs_err=gerr, at=gname, its_max=gmax,
              plain_f32_err=perr, rtol_of_max=BF16_GRAD_RTOL)
        fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, gerr)
        del outs, grads
    fwd = lambda prec: lambda: fel.fused_encoder_layer(x, mask, pos, layer, rate, DROPOUT_SEED,
                                                       prec)
    bwd = lambda prec: lambda: fel.fused_encoder_layer_bwd(x, mask, pos, g, layer, rate,
                                                           DROPOUT_SEED, prec)
    with torch.no_grad():
        ms, plain_ms = in_turns(fwd("bf16"), lambda: fel.fused_encoder_layer_reference(
            x, mask, pos, layer, rate, DROPOUT_SEED, "bf16"))
        ms_b, ms32 = in_turns(fwd("bf16"), fwd("f32"))
    xi, pi = x.clone().requires_grad_(), pos.clone().requires_grad_()
    out = fel.fused_encoder_layer_reference(xi, mask, pi, layer, rate, DROPOUT_SEED, "bf16")
    bms, plain_bms = in_turns(bwd("bf16"), lambda: torch.autograd.grad(
        out, [xi, pi, *params], g, retain_graph=True))
    bms_b, bms32 = in_turns(bwd("bf16"), bwd("f32"))
    del out
    with torch.no_grad():
        breakdown("fused_encoder_layer", fwd("bf16"), precision="bf16")
    breakdown("fused_encoder_layer_bwd", bwd("bf16"), precision="bf16")
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
    batch = to_tensors(example_batch(np.random.RandomState(SEED), cfg, TRAIN_B), device)
    model, _ = train_setup(cfg, device)
    runs = {"kernel": (model, batch, False),
            "plain": (copy.deepcopy(model), batch, True),
            "exact": (copy.deepcopy(model).double(),
                      {k: v.double() if v.is_floating_point() else v for k, v in batch.items()},
                      True)}
    logs, grads, launches, solves = {}, {}, {}, []
    for kind, (mdl, b, plain) in runs.items():
        _, step = train_setup(cfg, device, model=mdl, fused_decoder=fused_decoder)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with plain_kernels() if plain else recording_lsap(solves), \
                torch.profiler.profile(activities=acts) if kind == "kernel" else \
                contextlib.nullcontext() as prof:
            log = step(b)
            torch.cuda.synchronize()
        if kind == "kernel":         # the step's device operations and its peak memory
            device_ops = sum(e.count for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA)
            peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        launches[kind] = read_counts()
        logs[kind] = {k: float(v.double().mean()) for k, v in log.items()}
        grads[kind] = {n: p.grad for n, p in mdl.named_parameters() if p.grad is not None}
        del log, step
    want = per_step(cfg, fused_decoder)
    if launches["kernel"] != want:
        raise AssertionError(f"kernel step launches {launches['kernel']}, want {want}")
    if any(launches["plain"].values()) or any(launches["exact"].values()):
        raise AssertionError(f"a plain step launched kernels: {launches}")
    for kind, log in logs.items():
        if not all(np.isfinite(v) for v in log.values()):
            raise AssertionError(f"{kind} step log not finite: {log}")
    loss = {kind: log["loss"] for kind, log in logs.items()}
    tol = LOSS_RTOL * abs(loss["exact"]) + 2 * abs(loss["plain"] - loss["exact"])
    if not abs(loss["kernel"] - loss["exact"]) <= tol:
        raise AssertionError(f"step loss {loss} (tolerance {tol})")
    names = list(grads["exact"])
    if not grads["kernel"].keys() == grads["plain"].keys() == grads["exact"].keys():
        raise AssertionError("the steps gave gradients to different parameters")
    worst, worst_plain, _, _ = check_grads(
        "train step", names, *([grads[k][n] for n in names] for k in ("kernel", "plain", "exact")))
    tag = "train-q" if fused_decoder else "temporal-train" if fused_temporal else "train"
    extra = {}
    if fused_decoder:
        extra = dict(queries=Q_MULTI, fused_decoder=True, lsap_solves=len(solves),
                     lsap_problems_vs_scipy=check_lsap(solves))
    phase(tag, dtype="float32", B=TRAIN_B, fused_temporal=fused_temporal, **extra,
          loss=loss["kernel"], plain_loss=loss["plain"], float64_loss=loss["exact"],
          params=len(names), grad_max_abs_err=worst, plain_f32_grad_err=worst_plain,
          train_iou=logs["kernel"]["train_iou"], grad_norm=logs["kernel"]["grad_norm"],
          device_ops=device_ops, peak_mem_gb=f"{peak_gb:.2f}")
    phase("launches", path="train step" + (" fused_temporal" if fused_temporal else "")
          + (f" Q={Q_MULTI} fused_decoder" if fused_decoder else ""), **launches["kernel"])
    if fused_decoder:
        _, step = train_setup(multi_query(cfg, detr_dropout=0.1), device, fused_decoder=True)
        try:
            step(batch)
        except ValueError as err:
            phase("train-q", detr_dropout=0.1, fused_decoder=True, raised=json.dumps(str(err)))
        else:
            raise AssertionError("fused_decoder=True trained with detr_dropout 0.1")
    return launches["kernel"]


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
    for name, dt in seconds.items():
        n = 2 * TIMED_STEPS
        phase("timed", config=name, dtype="bfloat16", B=TRAIN_B, steps=n,
              step_ms=f"{dt / n * 1e3:.2f}", clips_per_s=f"{TRAIN_B * n / dt:.1f}",
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
    encoder layers at rate 0, the in-batch similarity's forward (#3), with
    fused_temporal the towers' temporal layers at rate 0 (#5) and with
    fused_decoder the decoder layers (#6), then one corpus similarity (#4)."""
    batches = -(-n_rows // cfg.train.batch_size_val)
    one = per_step(cfg, fused_decoder)
    return {"fused_encoder_layer": cfg.model.detr_enc_layers * batches,
            "fused_encoder_layer_bwd": 0, "xpool_sim_fwd": batches, "xpool_sim_bwd": 0,
            "xpool_sim_eval": 1, "flash_attention": 0,
            "fused_temporal_layer": one["fused_temporal_layer"] * batches,
            "fused_temporal_layer_bwd": 0,
            "fused_decoder_layer": one["fused_decoder_layer"] * batches,
            "fused_decoder_layer_bwd": 0}


def check_train_cli(tmp: str) -> tuple:
    """`cli.train` on EVAL_N generated rows, one epoch of the default
    Config(); returns (run directory, data root, the epoch's record, the
    run's launch counts)."""
    out_dir = os.path.join(tmp, "train")
    cfg = Config()
    reset_counts()
    t0 = time.perf_counter()
    train_cli.main(["--synthetic", str(EVAL_N), "--train.epochs", "1",
                    "--train.output_dir", out_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
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
    phase("train-cli", rows=EVAL_N, steps=rec["train"]["steps"], loss=rec["train"]["loss"],
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


RANK_KEYS = ("R1", "R3", "R5", "R10", "R20", "R25", "R50", "R100", "MedianR", "MeanR", "MRR")


def check_evaluate_cli(device: torch.device, tmp: str, run_dir: str, data_root: str,
                       record: dict) -> dict:
    """`cli.evaluate` on the run's best_r1 checkpoint against the trainer's
    record, then `evaluate` with and without kernel #4 on those weights;
    returns the evaluation CLI's launch counts."""
    cfg = Config()
    csv = os.path.join(data_root, "data.csv")
    reset_counts()
    t0 = time.perf_counter()
    results = evaluate_cli.main(["--ckpt", "best_r1", "--run-dir", run_dir, "--split", "val",
                                 "--data.val_csv", csv, "--data.feature_root", data_root,
                                 "--save-json", os.path.join(tmp, "results.json")])
    cli_s = time.perf_counter() - t0
    launches = read_counts()
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
    phase("launches", path="evaluate-cli", **launches)
    return launches


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

    video = PackedFeatureStore(os.path.join(out, "video_store"))
    music = PackedFeatureStore(os.path.join(out, "music_store"))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    name, card = check_device()
    build_kernels()
    entries = (check_encoder(device) + check_xpool(device) + check_temporal(device)
               + check_decoder(device))
    launches = check_train(device)
    fused_launches = check_train(device, fused_temporal=True)
    q_launches = check_train(device, fused_decoder=True)
    check_timed(device, card)
    engine, videos, vmask = check_slice(device)
    check_http(engine, videos, vmask)
    del engine
    entries.append(check_eval_kernel(device))
    with tempfile.TemporaryDirectory() as tmp:
        run_dir, data_root, record, fit_launches = check_train_cli(tmp)
        check_train_cli_fused(tmp, data_root)
        check_evaluate_cli(device, tmp, run_dir, data_root, record)
        check_eval_q(device, data_root)
    entries.append(check_flash(device))
    with tempfile.TemporaryDirectory() as tmp:
        extract_launches = check_extract(device, tmp)
    launches["xpool_sim_eval"] = fit_launches["xpool_sim_eval"]      # per evaluation
    launches["flash_attention"] = extract_launches["flash_attention"]  # per extraction
    for kernel in ("fused_temporal_layer", "fused_temporal_layer_bwd"):  # per fused_temporal step
        launches[kernel] = fused_launches[kernel]
    for kernel in ("fused_decoder_layer", "fused_decoder_layer_bwd"):    # per Q=10 fused step
        launches[kernel] = q_launches[kernel]
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
