"""Where the time goes in the PyTorch port's serving path, on one CUDA GPU.

    python3 scripts/profile_serving_cuda.py [--samples 25]

Builds the paper-width model (seeded random weights, float32) and a
4,096-track seeded index, warms up, times RetrievalEngine.query at B=1
and B=32 with and without the kernel (host clock, in turns), then traces one query
with torch.profiler and prints the device time by kernel, the query's wall
time and the device's busy share of it.  It also traces the fused encoder layer
alone at the query's DETR rows, so the kernel's three launches (QKV,
attention, FFN) can be read apart.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.device import resolve_device
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.serve.engine import RetrievalEngine, build_music_index

TRACKS = 4096   # MGSV-EC's catalog size
BATCH = 32      # the micro-batcher's max_batch


def device_table(prof, rows: int = 15) -> float:
    """Print device kernels by total time; return their sum in ms."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    for e in events[:rows]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
    return sum(e.device_time_total for e in events) / 1e3


def latencies(engine, videos, vmask, n: int) -> np.ndarray:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        engine.query(videos, vmask)
        out.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(out)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--samples", type=int, default=25,
                        help="timed queries per engine and turn")
    args = parser.parse_args()
    device = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())

    base = Config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, compute_dtype="float32"))
    data = cfg.data
    rng = np.random.default_rng(0)
    model = MaDe(cfg, torch.Generator().manual_seed(0)).to(device).eval()
    feats = rng.standard_normal((TRACKS, data.max_snippet_num, data.ast_dim),
                                dtype=np.float32)
    masks = np.ones((TRACKS, data.max_snippet_num), np.float32)
    index = build_music_index(model, [str(i) for i in range(TRACKS)], feats, masks,
                              batch_size=256)
    del feats
    engine = RetrievalEngine(model, cfg, index)
    plain = RetrievalEngine(model, cfg, index, use_fused_kernels=False)
    videos = rng.standard_normal((BATCH, data.max_v_frames, data.vit_dim),
                                 dtype=np.float32)
    vmask = np.ones(videos.shape[:2], np.float32)
    for _ in range(3):
        engine.query(videos, vmask)
        plain.query(videos, vmask)
    for b in (1, BATCH):
        # in turns: plain, kernel, kernel, plain
        runs = [latencies(e, videos[:b], vmask[:b], args.samples)
                for e in (plain, engine, engine, plain)]
        for name, lat in (("plain", np.concatenate([runs[0], runs[3]])),
                          ("kernel", np.concatenate([runs[1], runs[2]]))):
            q = np.percentile(lat, [25, 50, 75, 90])
            print(f"latency B={b} {name}: n={lat.size} p25={q[0]:.3f} p50={q[1]:.3f} "
                  f"p75={q[2]:.3f} p90={q[3]:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.query(videos, vmask)
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"query B={BATCH} tracks={TRACKS} dtype=float32: "
          f"wall {wall_ms:.3f} ms; device time by kernel:")
    busy = device_table(prof)
    print(f"  device busy {busy:.3f} ms = {busy / wall_ms:.3f} of the wall time")

    from mgsv_tpu_torch.ops.cuda.fused_encoder_layer import fused_encoder_layer

    rows = BATCH * 8                    # B x bucket(top_k=5)
    layer = model.detr_transformer.encoder.layers[0]
    x = torch.randn(rows, 152, cfg.model.dim_input, device=device)
    pos = torch.randn_like(x)
    mask = torch.ones(rows, 152, device=device)
    with torch.no_grad():
        fused_encoder_layer(x, mask, pos, layer)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fused_encoder_layer(x, mask, pos, layer)
            torch.cuda.synchronize()
    print(f"fused_encoder_layer rows={rows} L=152, 10 calls:")
    device_table(prof, rows=4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
