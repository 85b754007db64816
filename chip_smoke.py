"""Smoke run of the PyTorch/CUDA port (mgsv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA device

Drives the port's serving path at the paper widths (Config(): D=256, 50
frames, 96 snippets, 2 DETR encoder / 6 decoder layers) with seeded random
weights, in phases that each print one line and raise on failure:

  1. device   card name, and its name and power limit from nvidia-smi
  2. build    compiles the CUDA kernels from mgsv_tpu_torch/csrc
  3. kernel   each kernel against its plain PyTorch version on the card
              (float32, TF32 off), with both times at the serving shape
  4. slice    a 4,096-track index built through build_music_index, queries
              at B=1 and B=32 through RetrievalEngine with the kernel, held
              against the same engine without it; launch counts read over
              that run; the default bf16 config timed
  5. http     RetrievalServer on 127.0.0.1: /healthz and three /query
              replies equal to direct engine.query calls

then prints the kernels' JSON line and, last, {"ok": true, "device": ...}.
It exits non-zero, without that last line, when no CUDA device is present
or any phase fails.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import subprocess
import sys
import time

import numpy as np
import torch

from mgsv_tpu.config import Config
from mgsv_tpu_torch.core.device import resolve_device
from mgsv_tpu_torch.models.detr import DetrEncoderLayer
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
from mgsv_tpu_torch.runtime import kernels
from mgsv_tpu_torch.serve.engine import RetrievalEngine, build_music_index

SEED = 0
N_TRACKS = 4096            # MGSV-EC's catalog size
KERNEL_ROWS = (8, 256)     # fused rows B*k: a B=1 query, and B=32 x k-bucket 8
KERNEL_L = 152             # 50 frames + 96 snippets, padded to a multiple of 8
# Tolerance of the kernel against its plain version.  The kernel's GEMMs
# keep float32 accuracy (3xTF32 on the tensor cores, each tile's partial sum
# added in float32), so the two differ by rounding and summation order; the
# layer ends in LayerNorm, so its outputs are of order 1 and those
# differences move them by a few 1e-6.  1e-4 leaves more than an order of
# headroom and still catches any indexing or masking fault, which moves
# outputs by O(1).
KERNEL_ATOL = 1e-4
SPAN_ATOL_S = 5e-3         # localized moments, seconds on a 240 s scale
SCORE_ATOL = 1e-4


def phase(tag: str, /, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ragged_mask(rng: np.random.Generator, rows: int, length: int, lo: int) -> np.ndarray:
    lens = rng.integers(lo, length + 1, rows)
    return (np.arange(length)[None] < lens[:, None]).astype(np.float32)


def check_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    phase("device", name=json.dumps(name), count=torch.cuda.device_count())
    print(smi.splitlines()[0], flush=True)
    return name


def check_kernel(device: torch.device) -> dict:
    """The encoder-layer kernel against its plain version at the serving
    shapes; times at the larger one."""
    t0 = time.perf_counter()
    kernels.load("fused_encoder_layer")
    phase("build", kernel="fused_encoder_layer", seconds=f"{time.perf_counter() - t0:.2f}")

    cfg = Config().model
    d, heads, ffn = cfg.dim_input, cfg.detr_heads, cfg.detr_ffn_dim
    layer = DetrEncoderLayer(d, heads, ffn)
    layer.reset_parameters(torch.Generator().manual_seed(SEED))
    layer = layer.to(device)
    rng = np.random.default_rng(SEED)
    worst = 0.0
    with torch.no_grad():
        for rows in KERNEL_ROWS:
            x, pos = (torch.from_numpy(rng.standard_normal((rows, KERNEL_L, d),
                                                           dtype=np.float32)).to(device)
                      for _ in range(2))
            mask = torch.from_numpy(ragged_mask(rng, rows, KERNEL_L, 1)).to(device)
            out = fel.fused_encoder_layer(x, mask, pos, layer)
            torch.cuda.synchronize()
            ref = fel.fused_encoder_layer_reference(x, mask, pos, layer)
            err = (out - ref).abs().max().item()
            phase("kernel", name="fused_encoder_layer", rows=rows, L=KERNEL_L,
                  max_abs_err=err, atol=KERNEL_ATOL)
            if not torch.isfinite(out).all() or not err <= KERNEL_ATOL:
                raise AssertionError(f"fused_encoder_layer disagrees: {err} at rows={rows}")
            worst = max(worst, err)

        kernel = lambda: fel.fused_encoder_layer(x, mask, pos, layer)
        plain = lambda: fel.fused_encoder_layer_reference(x, mask, pos, layer)
        for fn in (kernel, plain):
            cuda_ms(fn, 3)
        # in turns (plain, kernel, kernel, plain) so drift hits both alike
        p1, k1, k2, p2 = (cuda_ms(fn, 20) for fn in (plain, kernel, kernel, plain))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    phase("kernel-time", name="fused_encoder_layer", rows=KERNEL_ROWS[-1], L=KERNEL_L,
          ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    return {"name": "fused_encoder_layer", "route": "cuda",
            "source": "mgsv_tpu_torch/csrc/fused_encoder_layer.cu",
            "replaces": "mgsv_tpu/ops/pallas/fused_encoder_layer.py:193",
            "launches": None, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
    """Index + queries at full width; returns (engine, videos, launches)."""
    base = Config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, compute_dtype="float32"))
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

    fel.fused_encoder_layer.launches = 0
    fused_runs = [timed_query(engine, f, mk) for f, mk in batches]
    launches = fel.fused_encoder_layer.launches
    if launches != m.detr_enc_layers * len(batches):
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{m.detr_enc_layers} per query call")
    for (res, ms), (feats_b, mask_b) in zip(fused_runs, batches):
        check_results(res, feats_b.shape[0], 5, cfg)
        plain, plain_ms = timed_query(plain_engine, feats_b, mask_b)
        span_err, score_err = compare(res, plain)
        phase("slice", B=feats_b.shape[0], top_k=5, dtype="float32", ms=f"{ms:.2f}",
              plain_ms=f"{plain_ms:.2f}", span_err_s=span_err, score_err=score_err)
    phase("launches", fused_encoder_layer=launches)

    bf16_model = MaDe(base, torch.Generator().manual_seed(SEED)).to(device).eval()
    bf16_engine = RetrievalEngine(bf16_model, base, index)
    for feats_b, mask_b in batches:
        bf16_engine.query(feats_b, mask_b)
        res, ms = timed_query(bf16_engine, feats_b, mask_b)
        check_results(res, feats_b.shape[0], 5, base)
        phase("slice", B=feats_b.shape[0], top_k=5, dtype="bfloat16", ms=f"{ms:.2f}")
    return engine, videos, vmask, launches


def check_http(engine: RetrievalEngine, videos, vmask) -> None:
    from mgsv_tpu.serve.server import RetrievalServer

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    name = check_device()
    kernel = check_kernel(device)
    engine, videos, vmask, launches = check_slice(device)
    check_http(engine, videos, vmask)
    kernel["launches"] = launches
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
