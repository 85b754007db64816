"""Times the attention kernel at the frozen AST tower's shapes, on one CUDA GPU.

    python3 scripts/time_attention_cuda.py [--batch 96 384] [--dtype float32 bfloat16]
        [--iters 5] [--rounds 2]

Builds csrc/flash_attention.cu from the checkout this script lies in and
times `flash_attention` against `torch.nn.functional.scaled_dot_product_attention`
(the yardstick; the port never calls it) on q, k, v as strided views of one
packed [B, 1214, 3, 12, 64] tensor, as the AST hands them over (B = 96: one
track's snippets; 384: the AST's batch under cli.extract_features --batch
32), with CUDA events: per round
SDPA, kernel, kernel, SDPA, `--iters` calls each.  Prints the card's name
and power limit, then one line per (dtype, B): each round's kernel and SDPA
ms, their medians, TFLOP/s of the kernel, its least time at the card's peak
(989 TFLOP/s bf16, 495 TF32) and its max abs error against the plain
version.  Run from two checkouts in one call to compare two versions of the
kernel on the same card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.nn.functional as F

from mgsv_tpu_torch.ops.cuda import flash_attention as fa

L, HEADS, HEAD_DIM = 1214, 12, 64      # AST tokens (1,212 patches + 2), heads, head dim
PEAK = {torch.bfloat16: 989e12, torch.float32: 495e12}
CHUNK = 16                              # batch rows per plain-version call (its scores)


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
    parser.add_argument("--batch", type=int, nargs="+", default=[96, 384],
                        help="snippets per call (96: one track; 384: an extraction chunk)")
    parser.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"])
    parser.add_argument("--iters", type=int, default=5, help="calls per timed turn")
    parser.add_argument("--rounds", type=int, default=2, help="SDPA-kernel-kernel-SDPA rounds")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_attention_cuda: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = HEAD_DIM ** -0.5
    for name in args.dtype:
        dtype = getattr(torch, name)
        for b in args.batch:
            qkv = torch.randn(b, L, 3, HEADS, HEAD_DIM, device=dev, generator=gen).to(dtype)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            with torch.no_grad():
                got = fa.flash_attention(q, k, v, scale).float()
                err = max((got[i:i + CHUNK] - fa.flash_attention_reference(
                    q[i:i + CHUNK], k[i:i + CHUNK], v[i:i + CHUNK], scale).float())
                    .abs().max().item() for i in range(0, b, CHUNK))
                del got
                kernel = lambda: fa.flash_attention(q, k, v, scale)
                sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
                cuda_ms(kernel, 1)
                cuda_ms(sdpa, 1)
                ks, ss = [], []
                for _ in range(args.rounds):
                    s1, k1, k2, s2 = (cuda_ms(fn, args.iters)
                                      for fn in (sdpa, kernel, kernel, sdpa))
                    ks += [k1, k2]
                    ss += [s1, s2]
            flops = 4 * b * HEADS * L * L * HEAD_DIM
            kms = statistics.median(ks)
            print(f"attention {name} B={b} H={HEADS} L={L}: kernel ms "
                  f"{' '.join(f'{x:.4f}' for x in ks)} median {kms:.4f}; SDPA ms "
                  f"{' '.join(f'{x:.4f}' for x in ss)} median {statistics.median(ss):.4f}; "
                  f"{flops / kms / 1e9:.1f} TFLOP/s, bound {flops / PEAK[dtype] * 1e3:.4f} ms; "
                  f"max abs err {err:.3g}", flush=True)
            del qkv, q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
