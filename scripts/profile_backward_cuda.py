"""Times the backward kernels #2 and #3 on one CUDA GPU, by kernel name.

    python3 scripts/profile_backward_cuda.py [--iters 10] [--only encoder|xpool]

At the default training shapes (the encoder layer at B=512, L=152, D=256,
FFN 1024, dropout 0.1; the X-Pool similarity at V=M=512, S=96, dropout
0.3), float32 with TF32 off: each backward kernel and its plain version
(autograd through the plain forward) timed in turns with CUDA events,
#2 given the training forward's saved set where the checkout keeps one
(plain, kernel, kernel, plain, `--iters` calls each), the encoder layer at
precision "f32" and "bf16"; then one call of each kernel under
torch.profiler, its device time summed by kernel name.  Prints the card's
name and power limit first.  Run from two checkouts in one call to compare
two versions on the same card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.models.detr import DetrEncoderLayer
from mgsv_tpu_torch.models.layers import l2_normalize
from mgsv_tpu_torch.models.xpool import XPoolTransformer
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps

B, L = 512, 152


def cuda_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, plain, iters: int) -> tuple:
    cuda_ms(kernel, 1)
    cuda_ms(plain, 1)
    p1, k1, k2, p2 = (cuda_ms(fn, iters) for fn in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def breakdown(tag: str, fn) -> None:
    """One call of fn under torch.profiler: device ms and launches by name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    print(f"[breakdown] {tag} device_ms={total:.4f}")
    for name, ms, count in rows[:14]:
        print(f"[breakdown]   {ms:9.4f} ms  {count:4d} x  {name[:110]}")


def randn(rng, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)


def encoder(device, iters: int) -> None:
    m = Config().model
    gen = torch.Generator().manual_seed(0)
    layer = DetrEncoderLayer(m.dim_input, m.detr_heads, m.detr_ffn_dim)
    layer.reset_parameters(gen)
    layer = layer.to(device)
    params = list(layer.parameters())
    rng = np.random.default_rng(0)
    x, pos, g = (randn(rng, (B, L, m.dim_input), device) for _ in range(3))
    lens = rng.integers(1, L + 1, B)
    mask = torch.from_numpy((np.arange(L)[None] < lens[:, None]).astype(np.float32)).to(device)
    rate = m.detr_dropout
    for prec in ("f32", "bf16"):
        # given the training forward's saved set, as the step runs it, where
        # the checkout keeps one
        acts = ({"acts": fel.fused_encoder_layer_fwd(x, mask, pos, layer, rate, 5, prec)[1]}
                if hasattr(fel, "fused_encoder_layer_fwd") else {})
        run = lambda: fel.fused_encoder_layer_bwd(x, mask, pos, g, layer, rate, 5, prec, **acts)
        a, b = run(), run()
        same = all(torch.equal(u, v) for u, v in zip([a[0], a[1], *a[2]], [b[0], b[1], *b[2]]))
        xi, pi = x.clone().requires_grad_(), pos.clone().requires_grad_()
        out = fel.fused_encoder_layer_reference(xi, mask, pi, layer, rate, 5, prec)
        kms, pms = in_turns(run, lambda: torch.autograd.grad(out, [xi, pi, *params], g,
                                                             retain_graph=True), iters)
        del out
        print(f"[time] fused_encoder_layer_bwd precision={prec} B={B} L={L} rate={rate} "
              f"ms={kms:.4f} plain_ms={pms:.4f} bit_identical={same}", flush=True)
        breakdown(f"fused_encoder_layer_bwd precision={prec}", run)


def xpool(device, iters: int) -> None:
    cfg = Config()
    d, s, rate = cfg.model.dim_input, cfg.data.max_snippet_num, cfg.model.xpool_dropout
    gen = torch.Generator().manual_seed(1)
    weights = [w.detach() for w in XPoolTransformer(d).to(device).stage_weights()]
    rng = np.random.default_rng(1)
    q, vhat = randn(rng, (B, d), device), l2_normalize(randn(rng, (B, d), device))
    k, v = (randn(rng, (B, s, d), device) for _ in range(2))
    lens = rng.integers(1, s + 1, B)
    mask = torch.from_numpy((np.arange(s)[None] < lens[:, None]).astype(np.float32)).to(device)
    g = randn(rng, (B, B), device)
    run = lambda: xps.xpool_sim_bwd(q, k, v, mask, vhat, weights, g, rate, 5)
    a, b = run(), run()
    same = all(torch.equal(u, w) for u, w in zip([*a[:4], *a[4]], [*b[:4], *b[4]]))
    ins = [t.clone().requires_grad_() for t in (q, k, v, vhat, *weights)]
    out = xps.xpool_sim_reference(ins[0], ins[1], ins[2], mask, ins[3], ins[4:], rate, 5)
    kms, pms = in_turns(run, lambda: torch.autograd.grad(out, ins, g, retain_graph=True), iters)
    del out
    print(f"[time] xpool_sim_bwd V={B} M={B} S={s} rate={rate} ms={kms:.4f} "
          f"plain_ms={pms:.4f} bit_identical={same}", flush=True)
    breakdown("xpool_sim_bwd", run)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=10, help="calls per timed turn")
    parser.add_argument("--only", choices=("encoder", "xpool"), default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_backward_cuda: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    device = torch.device("cuda")
    if args.only in (None, "encoder"):
        encoder(device, args.iters)
    if args.only in (None, "xpool"):
        xpool(device, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
