"""Where the time goes in the PyTorch port's training step, on one CUDA GPU.

    python3 scripts/profile_train_cuda.py [--steps 10] [--fused-temporal]
        [--queries 10 [--fused-decoder]]

Builds MaDe(Config()) (the paper widths, seeded random weights) and a
seeded batch of B=512 precomputed features, warms up, and times the step
(host clock around `--steps` steps ending in a synchronize) in the
default bfloat16 configuration and in float32, each with the kernels and
with their plain versions, in turns (plain, kernel, kernel, plain).  Then
it traces one bf16 step with torch.profiler and prints the device time by
kernel, the step's wall time and the device's busy share of it, and
the host's time by operator and its kernel launches, then traces the two
backward kernels alone at the step's shapes (the encoder layer's given the
training forward's saved set, where the checkout keeps one), so their
launches can be read apart.  With --fused-temporal the configurations set fused_temporal (both
temporal towers on the temporal-layer kernels, float32), and the temporal
backward at the audio tower's shape is traced too (given the training
forward's saved activations, where the checkout keeps them).  With --queries Q the
configurations have Q moment queries and detr_dropout 0 (the matcher on
the batched LSAP), and with --fused-decoder the step runs the DETR decoder
layers on the decoder-layer kernels (float32), whose backward at the
step's shape is traced too (given the training forward's saved set, where
the checkout keeps one).  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
import time
import warnings
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.device import resolve_device
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.models.detr import DetrDecoderLayer, DetrEncoderLayer
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.models.temporal import TemporalTransformer
from mgsv_tpu_torch.models.xpool import XPoolTransformer
from mgsv_tpu_torch.ops.cuda import fused_decoder_layer as fdl
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
from mgsv_tpu_torch.ops.cuda import fused_temporal_layer as ftl
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps
from mgsv_tpu_torch.runtime import kernels
from mgsv_tpu_torch.train.optimizer import make_optimizer
from mgsv_tpu_torch.train.step import make_train_step

BATCH = 512     # the paper's training batch
HORIZON = 1000  # schedule length the optimizer is built for


def device_table(prof, rows: int = 20) -> float:
    """Print device kernels by total time; return their sum in ms."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    for e in events[:rows]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
    return sum(e.device_time_total for e in events) / 1e3


def host_table(prof, rows: int = 15) -> None:
    """Print the host-side operators by their own CPU time, and the number
    of kernel launches the traced window made."""
    events = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    events.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in events[:rows]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                         "cudaLaunchKernelExC"))
    print(f"  kernel launches from the host: {launches}")


@contextlib.contextmanager
def plain_kernels():
    """The training step's kernel wrappers replaced by their plain versions
    (the model looks them up at each call)."""
    with mock.patch.object(fel, "fused_encoder_layer", fel.fused_encoder_layer_reference), \
            mock.patch.object(xps, "xpool_sim", xps.xpool_sim_reference), \
            mock.patch.object(ftl, "fused_temporal_layer", ftl.fused_temporal_layer_reference), \
            mock.patch.object(fdl, "fused_decoder_layer", fdl.fused_decoder_layer_reference):
        yield


def on_plain_kernels(step):
    def plain_step(batch):
        with plain_kernels():
            return step(batch)
    return plain_step


def steps_ms(step, batch, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10, help="timed steps per turn")
    parser.add_argument("--fused-temporal", action="store_true",
                        help="the temporal towers on the temporal-layer kernels")
    parser.add_argument("--queries", type=int, default=Config().model.num_moment_queries,
                        help="moment queries (above 1: detr_dropout 0)")
    parser.add_argument("--fused-decoder", action="store_true",
                        help="the DETR decoder on the decoder-layer kernels")
    args = parser.parse_args()
    device = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    kernels.build_all()

    base = Config()
    over = dict(fused_temporal=args.fused_temporal, num_moment_queries=args.queries)
    if args.queries > 1:
        over["detr_dropout"] = 0.0
    base = dataclasses.replace(base, model=dataclasses.replace(base.model, **over))
    print(f"fused_temporal={args.fused_temporal} queries={args.queries} "
          f"fused_decoder={args.fused_decoder}")
    warnings.simplefilter("ignore")   # the fused towers ignore bf16 by design
    batch = None
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, model=dataclasses.replace(base.model,
                                                                  compute_dtype=dtype))
        batch = to_tensors(example_batch(np.random.RandomState(0), cfg, BATCH), device)
        steps = {}
        for plain in (False, True):
            model = MaDe(cfg, torch.Generator().manual_seed(0)).to(device)
            step = make_train_step(model, cfg, make_optimizer(model, cfg, HORIZON),
                                   args.fused_decoder)
            steps[plain] = on_plain_kernels(step) if plain else step
            for _ in range(2):
                steps[plain](batch)
        torch.cuda.reset_peak_memory_stats(device)
        turns = [steps_ms(steps[plain], batch, args.steps) for plain in (True, False, False, True)]
        kernel_ms, plain_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        print(f"step dtype={dtype} B={BATCH}: kernels {kernel_ms:.2f} ms "
              f"({BATCH / kernel_ms * 1e3:.1f} clips/s; turns {turns[1]:.2f}, {turns[2]:.2f}), "
              f"plain {plain_ms:.2f} ms (turns {turns[0]:.2f}, {turns[3]:.2f}); peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
        if dtype == "bfloat16":
            kernel_step = steps[False]
            kernel_step(batch)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kernel_step(batch)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            print(f"one bf16 step B={BATCH}: wall {wall_ms:.3f} ms under the profiler; "
                  f"device time by kernel:")
            busy = device_table(prof)
            print(f"  device busy {busy:.3f} ms = {busy / wall_ms:.3f} of the wall time")
            print("host time by operator (self CPU time):")
            host_table(prof)
        del steps

    m = base.model
    rng = np.random.default_rng(0)
    x, pos, g = (torch.from_numpy(rng.standard_normal((BATCH, 152, m.dim_input),
                                                      dtype=np.float32)).to(device)
                 for _ in range(3))
    mask = torch.ones(BATCH, 152, device=device)
    layer = DetrEncoderLayer(m.dim_input, m.detr_heads, m.detr_ffn_dim)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    layer = layer.to(device)
    s = base.data.max_snippet_num
    q, vhat = torch.randn(BATCH, m.dim_input, device=device), torch.randn(
        BATCH, m.dim_input, device=device)
    k, v = (torch.randn(BATCH, s, m.dim_input, device=device) for _ in range(2))
    smask = torch.ones(BATCH, s, device=device)
    weights = [w.detach() for w in XPoolTransformer(m.dim_input).to(device).stage_weights()]
    gsim = torch.randn(BATCH, BATCH, device=device)
    rows, d, f = BATCH * 152, m.dim_input, m.detr_ffn_dim
    # the backward's GEMMs, in GFLOP: the forward's out-proj and FFN again,
    # the five activation gradients, the five weight gradients
    print(f"encoder backward GEMM work per call (rows={rows}): recompute "
          f"{2 * rows * (d * d + 2 * d * f) / 1e9:.1f} GFLOP, activation gradients "
          f"{2 * rows * (2 * d * f + d * d + 3 * d * d + 2 * d * d) / 1e9:.1f} GFLOP, "
          f"weight gradients {2 * rows * (2 * d * f + d * d + 3 * d * d) / 1e9:.1f} GFLOP")
    # given the training forward's saved set, as the step runs it, where the
    # checkout keeps one
    eacts = ({"acts": fel.fused_encoder_layer_fwd(x, mask, pos, layer, m.detr_dropout, 1)[1]}
             if hasattr(fel, "fused_encoder_layer_fwd") else {})
    calls = {
        f"fused_encoder_layer_bwd B={BATCH} L=152 rate={m.detr_dropout}":
            lambda: fel.fused_encoder_layer_bwd(x, mask, pos, g, layer, m.detr_dropout, 1,
                                                **eacts),
        f"xpool_sim_bwd V=M={BATCH} S={s} rate={m.xpool_dropout}":
            lambda: xps.xpool_sim_bwd(q, k, v, smask, vhat, weights, gsim, m.xpool_dropout, 1),
    }
    if args.fused_temporal:
        trm = TemporalTransformer(d, 1, m.temporal_heads, m.temporal_mlp_dim, d)
        trm.reset_parameters(torch.Generator().manual_seed(0))
        tlayer = trm.layers[0].to(device)
        tx, tg = (torch.randn(BATCH, s, d, device=device) for _ in range(2))
        # given the training forward's saved activations, as the step runs it,
        # where the checkout keeps them
        acts = ({"acts": ftl.fused_temporal_layer_fwd(tx, smask, tlayer, m.temporal_dropout, 1)[1]}
                if hasattr(ftl, "fused_temporal_layer_fwd") else {})
        calls[f"fused_temporal_layer_bwd B={BATCH} L={s} rate={m.temporal_dropout}"] = (
            lambda: ftl.fused_temporal_layer_bwd(tx, smask, tg, tlayer, m.temporal_dropout, 1,
                                                 **acts))
    if args.fused_decoder:
        dlayer = DetrDecoderLayer(d, m.detr_heads, f, self_attn=m.decoder_self_attn)
        dlayer.reset_parameters(torch.Generator().manual_seed(0))
        dlayer = dlayer.to(device)
        tq, qp, dg = (torch.randn(BATCH, args.queries, d, device=device) for _ in range(3))
        # given the training forward's saved set, as the step runs it, where
        # the checkout keeps one
        dacts = ({"acts": fdl.fused_decoder_layer_fwd(tq, x, mask, pos, qp, dlayer)[1]}
                 if hasattr(fdl, "SAVED") else {})
        calls[f"fused_decoder_layer_bwd B={BATCH} Q={args.queries} L=152"] = (
            lambda: fdl.fused_decoder_layer_bwd(tq, x, mask, pos, qp, dg, dlayer, **dacts))
    for name, fn in calls.items():
        fn()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        print(f"{name}, 3 calls:")
        device_table(prof, rows=8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
