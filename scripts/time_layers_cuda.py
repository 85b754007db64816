"""Times the temporal-tower layer (#5) and the DETR decoder layer (#6) kernels
at the port's shapes, on one CUDA GPU.

    python3 scripts/time_layers_cuda.py [--iters 5] [--rounds 2] [--breakdown]
        [--layer temporal|decoder|both]

Builds csrc/fused_{temporal,decoder}_layer{,_bwd}.cu from the checkout this
script lies in and times, with CUDA events, `iters` calls per round of
  * #5's forward and backward (`fused_temporal_layer`,
    `fused_temporal_layer_bwd`, recomputing) for the audio (L = 96) and
    video (L = 50) towers at B = 512, rate 0.8 (a training step of
    Config(fused_temporal=True)), and both at the evaluation's B = 40,
    rate 0; where the checkout has `fused_temporal_layer_fwd`, at rate 0.8
    also its training forward (which keeps the saved activations) and the
    backward given them (what a training step runs);
  * #6's forward and backward (`fused_decoder_layer`,
    `fused_decoder_layer_bwd`, recomputing) at B = 512, L = 152 for Q = 10
    and Q = 1 moment queries, and Q = 1 at B = 40; where the checkout has
    `fused_decoder_layer_fwd`, also the backward given the forward's memory
    k|v (what a training step runs),
on seeded inputs (the layers' weights off their initial values, ragged key
masks).  Prints the card's name and power limit, then one line per call:
each round's ms, their median, TFLOP/s, the least time (chip_smoke.py's
bound: the operations at 495 TFLOP/s TF32 or the bytes at 3.35 TB/s,
whichever is larger) and the max error against the plain version (of the
output, abs; of the gradients, over the largest gradient magnitude).
With --breakdown, one call of each at rate 0.8 (#5) and of each of #6's
under torch.profiler, its device time by kernel name ([breakdown] lines).
--layer times one of the two layers alone.  Run from two checkouts in one
call (parent, change, change, parent) to compare two versions on the same
card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from mgsv_tpu_torch.models.detr import DetrDecoderLayer
from mgsv_tpu_torch.models.temporal import TemporalTransformer
from mgsv_tpu_torch.ops.cuda import fused_decoder_layer as fdl
from mgsv_tpu_torch.ops.cuda import fused_temporal_layer as ftl

D, FFN, HEADS, L_MEM = 256, 1024, 8, 152   # Config(): widths, DETR memory rows
PEAK_TF32, PEAK_HBM = 495e12, 3.35e12
# (tower, B, L, rate) and (B, Q)
TEMPORAL = [("audio", 512, 96, 0.8), ("video", 512, 50, 0.8), ("audio", 40, 96, 0.0),
            ("video", 40, 50, 0.0)]
DECODER = [(512, 10), (512, 1), (40, 1)]


def cuda_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def breakdown(what: str, fn) -> None:
    """One call of fn under torch.profiler, after a warm-up call that the
    profiler runs but does not keep: device time by kernel name, beside the
    call's time from CUDA events."""
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
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in kept[0]
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("ProfilerStep")), key=lambda r: -r[1])
    print(f"[breakdown] {what}: device_ms={sum(r[1] for r in rows):.4f} "
          f"events_ms={events_ms:.4f} kernels={len(rows)}", flush=True)
    for kernel, ms, count in rows:
        print(f"[breakdown]   {ms:9.4f} ms {count:4d} x {kernel[:120]}", flush=True)


def least_ms(flops: float, nbytes: int) -> float:
    return max(flops / PEAK_TF32, nbytes / PEAK_HBM) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def report(what: str, times, flops: float, nb: int, err: float) -> None:
    med = statistics.median(times)
    print(f"{what}: ms {' '.join(f'{x:.4f}' for x in times)} median {med:.4f}; "
          f"{flops / med / 1e9:.1f} TFLOP/s, bound {least_ms(flops, nb):.4f} ms; "
          f"max err {err:.3g}", flush=True)


def grad_err(kernel, plain) -> float:
    """The largest |kernel - plain| of any gradient over the largest
    magnitude of any gradient."""
    return (max((k - p).abs().max().item() for k, p in zip(kernel, plain))
            / max(p.abs().max().item() for p in plain))


def ragged(rng: np.random.Generator, rows: int, length: int, dev) -> torch.Tensor:
    lens = rng.integers(1, length + 1, rows)
    return torch.from_numpy((np.arange(length)[None] < lens[:, None]).astype(np.float32)).to(dev)


def perturbed(module: torch.nn.Module, gen: torch.Generator) -> torch.nn.Module:
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return module


def time_temporal(dev, args) -> None:
    gen = torch.Generator().manual_seed(5)
    trm = TemporalTransformer(D, 1, HEADS, FFN, D)
    trm.reset_parameters(gen)
    layer = perturbed(trm.layers[0], gen).to(dev)
    params = list(ftl._layer_tensors(layer))   # the order of the backward's gradients
    saved_acts = hasattr(ftl, "fused_temporal_layer_fwd")
    rng = np.random.default_rng(5)
    for tower, b, length, rate in TEMPORAL:
        randn = lambda: torch.from_numpy(
            rng.standard_normal((b, length, D), dtype=np.float32)).to(dev)
        x, g, mask = randn(), randn(), ragged(rng, b, length, dev)
        tag = f"{tower} B={b} L={length} rate={rate}"
        flops = b * (8 * length * D * D + 4 * length * length * D + 4 * length * D * FFN)
        fwd = lambda: ftl.fused_temporal_layer(x, mask, layer, rate, 7)
        with torch.no_grad():
            err = (fwd() - ftl.fused_temporal_layer_reference(x, mask, layer, rate, 7)).abs().max()
            cuda_ms(fwd, 1)
            times = [cuda_ms(fwd, args.iters) for _ in range(args.rounds)]
        report(f"fused_temporal_layer {tag}", times, flops, nbytes(x, mask, x, *params),
               err.item())
        xi = x.clone().requires_grad_()
        out = ftl.fused_temporal_layer_reference(xi, mask, layer, rate, 7)
        plain = torch.autograd.grad(out, [xi, *params], g)
        del out, xi
        calls = [("fused_temporal_layer_bwd", None)]
        if saved_acts and rate > 0.0:
            train_fwd = lambda: ftl.fused_temporal_layer_fwd(x, mask, layer, rate, 7)
            with torch.no_grad():
                cuda_ms(train_fwd, 1)
                times = [cuda_ms(train_fwd, args.iters) for _ in range(args.rounds)]
                report(f"fused_temporal_layer training forward (saves acts) {tag}", times, flops,
                       nbytes(x, mask, x, *params), 0.0)
                acts = train_fwd()[1]
            calls.append(("fused_temporal_layer_bwd saved acts", acts))
        bwd_bytes = nbytes(x, mask, g, *params, x, *params)
        for name, acts in calls:
            bwd = lambda: ftl.fused_temporal_layer_bwd(x, mask, g, layer, rate, 7, **(
                {} if acts is None else {"acts": acts}))
            dx, grads = bwd()
            err = grad_err([dx, *grads], plain)
            del dx, grads
            cuda_ms(bwd, 1)
            times = [cuda_ms(bwd, args.iters) for _ in range(args.rounds)]
            report(f"{name} {tag}", times, 2 * flops, bwd_bytes, err)
            if args.breakdown and rate > 0.0:
                breakdown(f"{name} {tag}", bwd)
        if args.breakdown and rate > 0.0:
            with torch.no_grad():
                breakdown(f"fused_temporal_layer {tag}", fwd)
        del plain, calls, x, g, mask


def time_decoder(dev, args) -> None:
    gen = torch.Generator().manual_seed(6)
    layer = DetrDecoderLayer(D, HEADS, FFN, self_attn=True)
    layer.reset_parameters(gen)
    layer = perturbed(layer, gen).to(dev)
    params = list(fdl._layer_tensors(layer))   # the order of the backward's gradients
    saved_kv = hasattr(fdl, "fused_decoder_layer_fwd")
    rng = np.random.default_rng(6)
    for b, q in DECODER:
        randn = lambda n: torch.from_numpy(
            rng.standard_normal((b, n, D), dtype=np.float32)).to(dev)
        tgt, qpos, g, mem, pos = randn(q), randn(q), randn(q), randn(L_MEM), randn(L_MEM)
        mask = ragged(rng, b, L_MEM, dev)
        ins = (tgt, mem, mask, pos, qpos)
        tag = f"B={b} Q={q} L={L_MEM}"
        rows, mrows = b * q, b * L_MEM
        flops = (2 * mrows * D * 2 * D + 2 * rows * D * 3 * D + 4 * b * q * q * D
                 + 6 * rows * D * D + 4 * b * q * L_MEM * D + 4 * rows * D * FFN)
        fwd = lambda: fdl.fused_decoder_layer(*ins, layer)
        with torch.no_grad():
            err = (fwd() - fdl.fused_decoder_layer_reference(*ins, layer)).abs().max()
            cuda_ms(fwd, 1)
            times = [cuda_ms(fwd, args.iters) for _ in range(args.rounds)]
        report(f"fused_decoder_layer {tag}", times, flops,
               nbytes(tgt, qpos, mem, pos, mask, *params, tgt), err.item())
        leaves = [t.clone().requires_grad_() for t in (tgt, mem, pos, qpos)]
        out = fdl.fused_decoder_layer_reference(leaves[0], leaves[1], mask, leaves[2],
                                                leaves[3], layer)
        plain = torch.autograd.grad(out, [*leaves, *params], g)
        del out, leaves
        calls = [("fused_decoder_layer_bwd", None)]
        if saved_kv:
            with torch.no_grad():
                kv = fdl.fused_decoder_layer_fwd(*ins, layer)[1]
            calls.append(("fused_decoder_layer_bwd saved k|v", kv))
        bwd_bytes = nbytes(tgt, qpos, mem, pos, mask, g, *params, tgt, qpos, mem, pos, *params)
        for name, kv in calls:
            bwd = lambda: fdl.fused_decoder_layer_bwd(*ins, g, layer, **(
                {} if kv is None else {"kv": kv}))
            res = bwd()
            err = grad_err([*res[:4], *res[4]], plain)
            del res
            cuda_ms(bwd, 1)
            times = [cuda_ms(bwd, args.iters) for _ in range(args.rounds)]
            report(f"{name} {tag}", times, 2 * flops, bwd_bytes, err)
            if args.breakdown:
                breakdown(f"{name} {tag}", bwd)
        if args.breakdown:
            with torch.no_grad():
                breakdown(f"fused_decoder_layer {tag}", fwd)
        del plain, calls, tgt, qpos, g, mem, pos, mask, ins


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=5, help="calls per timed round")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--breakdown", action="store_true",
                        help="also each call's device time by kernel name")
    parser.add_argument("--layer", choices=("temporal", "decoder", "both"), default="both")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_layers_cuda: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if args.layer != "decoder":
        time_temporal(dev, args)
    if args.layer != "temporal":
        time_decoder(dev, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
