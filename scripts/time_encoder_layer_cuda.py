"""Times the encoder-layer kernel at the serving shapes, on one CUDA GPU.

    python3 scripts/time_encoder_layer_cuda.py [--rows 8 256] [--iters 50] [--rounds 3]
        [--backward 512]

Builds csrc/fused_encoder_layer.cu from the checkout this script lies in and
times `fused_encoder_layer` (rate 0, as the serving engine calls it) against
its plain PyTorch version at the paper's widths (D=256, 8 heads, FFN 1024,
L=152) for each fused row count, float32 with TF32 off, with CUDA events:
per round plain, kernel, kernel, plain, `--iters` calls each.  Prints the
card's name and power limit, one line per row count (each round's kernel
and plain ms, their medians, the kernel's max abs error against the plain
version), and the kernel's registers per thread where the build log has
them.  Run from two checkouts in one call to compare two versions of the
kernel on the same card.  With --backward B it also times the backward
kernel (`fused_encoder_layer_bwd`, given the training forward's saved set
where the checkout keeps one) at B batch rows of L=152, dropout 0.1 (the
training step's shape and rate), in `--rounds` turns of `--iters`
calls, and checks that two calls give the same gradients bit for bit.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from mgsv_tpu_torch.models.detr import DetrEncoderLayer
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
from mgsv_tpu_torch.runtime import kernels

D, HEADS, FFN, L = 256, 8, 1024, 152    # Config() widths; 50 + 96 tokens padded to 152


def cuda_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, nargs="+", default=[8, 256],
                        help="fused rows B*k (8: a B=1 query; 256: B=32 x k-bucket 8)")
    parser.add_argument("--iters", type=int, default=50, help="calls per timed turn")
    parser.add_argument("--rounds", type=int, default=3, help="plain-kernel-kernel-plain rounds")
    parser.add_argument("--backward", type=int, default=0,
                        help="also time the backward kernel at this many batch rows")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_encoder_layer_cuda: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    print(f"checkout: {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}")
    device = torch.device("cuda")
    kernels.load("fused_encoder_layer")
    log = getattr(kernels, "build_logs", {}).get("fused_encoder_layer", "")
    regs = re.findall(r"Function properties for (\S+)|Used (\d+) registers", log)
    names, found = None, []
    for name, reg in regs:
        if name:
            names = name
        elif names is not None:
            found.append(f"{names}:{reg}")
            names = None
    if found:
        print("registers: " + " ".join(found))

    gen = torch.Generator().manual_seed(0)
    layer = DetrEncoderLayer(D, HEADS, FFN)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    layer = layer.to(device)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for rows in args.rows:
            x, pos = (torch.from_numpy(rng.standard_normal((rows, L, D), dtype=np.float32)
                                       ).to(device) for _ in range(2))
            lens = rng.integers(1, L + 1, rows)
            mask = torch.from_numpy((np.arange(L)[None] < lens[:, None]).astype(np.float32)
                                    ).to(device)
            kernel = lambda: fel.fused_encoder_layer(x, mask, pos, layer)
            plain = lambda: fel.fused_encoder_layer_reference(x, mask, pos, layer)
            err = (kernel() - plain()).abs().max().item()
            cuda_ms(kernel, 3)
            cuda_ms(plain, 3)
            k_ms, p_ms = [], []
            for _ in range(args.rounds):
                p1, k1, k2, p2 = (cuda_ms(fn, args.iters) for fn in (plain, kernel, kernel, plain))
                k_ms += [k1, k2]
                p_ms += [p1, p2]
            print(f"rows={rows} L={L} rate=0: kernel median {statistics.median(k_ms):.4f} ms "
                  f"({' '.join(f'{t:.4f}' for t in k_ms)}), plain median "
                  f"{statistics.median(p_ms):.4f} ms ({' '.join(f'{t:.4f}' for t in p_ms)}), "
                  f"max abs err {err:.3e}", flush=True)
    if args.backward:
        b = args.backward
        x, pos, g = (torch.from_numpy(rng.standard_normal((b, L, D), dtype=np.float32)
                                      ).to(device) for _ in range(3))
        lens = rng.integers(1, L + 1, b)
        mask = torch.from_numpy((np.arange(L)[None] < lens[:, None]).astype(np.float32)
                                ).to(device)
        # given the training forward's saved set, as the step runs it, where
        # the checkout keeps one
        acts = ({"acts": fel.fused_encoder_layer_fwd(x, mask, pos, layer, 0.1, 1234)[1]}
                if hasattr(fel, "fused_encoder_layer_fwd") else {})
        bwd = lambda: fel.fused_encoder_layer_bwd(x, mask, pos, g, layer, 0.1, 1234, **acts)
        first, second = bwd(), bwd()
        same = all(torch.equal(a, c) for a, c in zip([*first[:2], *first[2]],
                                                     [*second[:2], *second[2]]))
        cuda_ms(bwd, 2)
        b_ms = [cuda_ms(bwd, args.iters) for _ in range(args.rounds)]
        print(f"backward B={b} L={L} rate=0.1: kernel median {statistics.median(b_ms):.4f} ms "
              f"({' '.join(f'{t:.4f}' for t in b_ms)}), two calls bit-identical {same}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
