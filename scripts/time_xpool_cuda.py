"""Times the X-Pool forward kernels at the port's shapes, on one CUDA GPU.

    python3 scripts/time_xpool_cuda.py [--iters 5] [--rounds 2]

Builds csrc/xpool_sim_train.cu from the checkout this script lies in and
times, with CUDA events, `iters` calls per round of
  * `xpool_sim_fwd` (#3's training forward) at V = M = 512, S = 96, rate 0.3
    (one step of the default Config() at B = 512);
  * `xpool_sim_eval` (#4) at V = M = 2,048, S = 96 (an evaluation's corpus)
    and at V = 32, M = 4,096 (the serving scan's shape),
on seeded inputs (X-Pool stage weights off identity, ragged snippet masks).
Prints the card's name and power limit, then one line per shape: each
round's ms, their median, TFLOP/s of the least work (chip_smoke.py's
`xpool_pair_flops`), the least time at the TF32 rate (495 TFLOP/s) and the
max abs error against the plain version.  Run from two checkouts in one
call (parent, change, change, parent) to compare two versions of the
kernel on the same card.
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

from mgsv_tpu_torch.models.xpool import XPoolTransformer
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps

D, S = 256, 96                          # X-Pool width, snippets per track (Config())
PEAK_TF32 = 495e12
# (name, V, M, dropout rate)
SHAPES = [("xpool_sim_fwd", 512, 512, 0.3), ("xpool_sim_eval", 2048, 2048, 0.0),
          ("xpool_sim_eval", 32, 4096, 0.0)]


def cuda_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def least_flops(vc: int, mc: int) -> int:
    """chip_smoke.py's xpool_pair_flops: per pair 4 S D + 2 D^2 + 2 D, per
    track 2 S D^2 (Wout once per snippet)."""
    return vc * mc * (4 * S * D + 2 * D * D + 2 * D) + mc * S * 2 * D * D


def inputs(vc: int, mc: int, dev: torch.device, seed: int = 0):
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    xpool = XPoolTransformer(D)
    with torch.no_grad():
        for p in xpool.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    weights = [w.detach() for w in xpool.to(dev).stage_weights()]
    randn = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
    q, vhat = randn(vc, D), torch.nn.functional.normalize(randn(vc, D), dim=-1)
    k, v = randn(mc, S, D), randn(mc, S, D)
    lens = rng.integers(1, S + 1, mc)
    mask = torch.from_numpy((np.arange(S)[None] < lens[:, None]).astype(np.float32)).to(dev)
    return q, k, v, mask, vhat, weights


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=5, help="calls per timed round")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_xpool_cuda: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for name, vc, mc, rate in SHAPES:
        q, k, v, mask, vhat, w = inputs(vc, mc, dev)
        with torch.no_grad():
            if name == "xpool_sim_fwd":
                kernel = lambda: xps.xpool_sim_fwd(q, k, v, mask, vhat, w, rate, 7)
                plain = xps.xpool_sim_reference(q, k, v, mask, vhat, w, rate, 7)
            else:
                kernel = lambda: xps.xpool_sim_eval(q, k, v, mask, vhat, w)
                plain = xps.xpool_sim_eval_reference(q, k, v, mask, vhat, w)
            err = (kernel() - plain).abs().max().item()
            del plain
            cuda_ms(kernel, 1)
            times = [cuda_ms(kernel, args.iters) for _ in range(args.rounds)]
        med = statistics.median(times)
        flops = least_flops(vc, mc)
        print(f"{name} V={vc} M={mc} S={S} rate={rate}: ms "
              f"{' '.join(f'{x:.4f}' for x in times)} median {med:.4f}; "
              f"{flops / med / 1e9:.1f} TFLOP/s of the least work, bound "
              f"{flops / PEAK_TF32 * 1e3:.4f} ms; max abs err {err:.3g}", flush=True)
        del q, k, v, mask, vhat, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
