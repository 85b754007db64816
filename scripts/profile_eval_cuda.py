"""Where the time goes in the PyTorch port's evaluation, on one CUDA GPU.

    python3 scripts/profile_eval_cuda.py [--rows 2048] [--device-data off|on]

Builds MaDe(Config()) (the paper widths, seeded random weights) and a
generated dataset of `--rows` rows (data/synthetic.py, in a temporary
directory), with `--device-data on` made resident on the card
(data/device_data.py, the upload timed), then times on the host clock,
each ending in a synchronize: the input alone (the host pipeline,
`prefetch_epoch` at B=40, or the resident gather of the evaluation's
padded order), the input with the evaluation step per batch, the corpus similarity with kernel #4 and
with the plain blocked path (in turns), the ranking, and `evaluate` whole
with and without the kernel (in turns).  Then it traces one `evaluate`
with torch.profiler and prints the device time by kernel and the device's
busy share of the wall time.  Prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.device import resolve_device
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.device_data import (DeviceResidentData, dataset_device_bytes,
                                             gather_batch)
from mgsv_tpu_torch.data.pipeline import prefetch_epoch
from mgsv_tpu_torch.eval import metrics as M
from mgsv_tpu_torch.eval.evaluator import corpus_similarity, evaluate
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.runtime import kernels
from mgsv_tpu_torch.train.step import make_eval_step


def seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def in_turns(a, b, pairs: int = 1):
    """([a s], [b s]): b, a, a, b, b, a, ... after one call each."""
    a(), b()
    times = {a: [], b: []}
    for i in range(2 * pairs):
        for fn in ((b, a) if i % 2 == 0 else (a, b)):
            times[fn].append(seconds(fn))
    return times[a], times[b]


def show(times, unit: float = 1.0) -> str:
    return " ".join(f"{t * unit:.3f}" for t in times)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=2048, help="rows of the generated split")
    parser.add_argument("--device-data", choices=("off", "on"), default="off",
                        help="on: evaluate the split resident on the card")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_eval_cuda: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    kernels.build_all()
    cfg = Config()
    batch = cfg.train.batch_size_val
    model = MaDe(cfg, torch.Generator().manual_seed(0)).to(device).eval()
    eval_step = make_eval_step(model, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        synthetic.generate(tmp, n_rows=args.rows, data_cfg=cfg.data)
        data = synthetic.open_synthetic(tmp, cfg.data)
        print(f"data: {args.rows} rows generated in {time.perf_counter() - t0:.2f} s")
        if args.device_data == "on":
            host = data
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data = DeviceResidentData(host, device)
            torch.cuda.synchronize()
            upload = time.perf_counter() - t0
            print(f"resident: {dataset_device_bytes(host)} bytes uploaded in {upload:.3f} s")

        def batches():
            """The evaluation's batches on the card, as evaluate feeds them."""
            if args.device_data == "on":
                pad = (-args.rows) % batch
                order = np.concatenate([np.arange(args.rows), np.full(pad, args.rows - 1)])
                for idx in torch.from_numpy(order.reshape(-1, batch)).to(device):
                    yield gather_batch(data.tree, idx)
                return
            with contextlib.closing(prefetch_epoch(data, batch, shuffle=False, drop_last=False,
                                                   device=device)) as stream:
                for b, _ in stream:
                    yield b

        def pipeline():
            for _ in batches():
                pass

        outs = []

        def forward():
            outs.clear()
            for b in batches():
                outs.append(eval_step(b))

        pipeline()
        print(f"input alone ({'resident gather' if args.device_data == 'on' else 'pipeline'}): "
              f"{seconds(pipeline):.3f} s ({-(-args.rows // batch)} batches of {batch})")
        forward()
        print(f"input + eval step: {seconds(forward):.3f} s")
        cat = lambda k: torch.cat([o[k] for o in outs])[:args.rows]
        embs = [cat(k) for k in ("video_emb", "music_emb", "seg_tokens", "segment_mask")]
        sims = {}

        def corpus(fused):
            return lambda: sims.__setitem__(fused, corpus_similarity(
                model, *embs, cfg, use_fused_kernel=fused))

        fused_s, plain_s = in_turns(corpus(True), corpus(False))
        print(f"corpus similarity ms: kernel #4 {show(fused_s, 1e3)}, plain blocked "
              f"{show(plain_s, 1e3)}")
        ids = list(data.index.music_ids)
        for fused in (True, False):
            print(f"ranking on the device, {'kernel' if fused else 'plain'} similarity: "
                  f"{seconds(lambda: M.recall_metrics(sims[fused], ids)) * 1e3:.2f} ms")
        whole_f, whole_p = in_turns(lambda: evaluate(model, data, cfg, use_fused_sim=True),
                                    lambda: evaluate(model, data, cfg, use_fused_sim=False),
                                    pairs=3)
        print(f"evaluate s: kernel #4 {show(whole_f)}, plain {show(whole_p)}")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = seconds(lambda: evaluate(model, data, cfg))
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        events.sort(key=lambda e: e.device_time_total, reverse=True)
        busy = sum(e.device_time_total for e in events) / 1e6
        print(f"traced evaluate: wall {wall:.3f} s, device busy {busy:.3f} s "
              f"(share {busy / wall:.3f})")
        for e in events[:12]:
            print(f"  {e.device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
