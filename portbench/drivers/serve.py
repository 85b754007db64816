"""Open-loop queries through the micro-batcher into the retrieval engine.

Set-up makes the weights and the catalog's snippet features from the
seed, builds the program's model, its index with
serve/engine.py::build_music_index, a RetrievalEngine over it and a
serve/server.py::MicroBatcher in front of it (the engine behind a timing
proxy), and warms the engine's batch buckets.  The window sends requests
on a fixed schedule (generate.arrivals) from a pool of seeded videos, each
from a client thread that waits on its own reply; a request is timed from
when it was due to when its reply arrived, and one refused or failed
counts as failed.  The window closes when every request due in it has
replied (or `drain_seconds` later).  With `--trace 1` the loop runs
`trace_seconds` more under the profiler.  Then the check: a seeded sample
of the window's replies, the longest video among them, against the plain
reference over the same catalog and weights.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait as wait_for

import numpy as np
import torch

from portbench import check, flops, generate
from portbench.harness import (Cell, LayerContext, Outcome, counter_paths,
                               port_config, read_counter, settle)
from portbench.reference import made as R
from portbench.reference.precision import lowered
from portbench.trace import traced
from portbench.weights import make_weights

FAULTS = ("altered_answer",)


def bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class TimedEngine:
    """The engine as the batcher sees it, with the host time and the batch
    of every query recorded."""

    def __init__(self, engine, fault=None):
        self.engine, self.cfg, self.fault = engine, engine.cfg, fault
        self.seconds, self.batches = 0.0, []
        self.lock = threading.Lock()

    def query(self, feats, masks, top_k=5):
        t = time.perf_counter()
        out = self.engine.query(feats, masks, top_k=top_k)
        with self.lock:
            self.seconds += time.perf_counter() - t
            self.batches.append(feats.shape[0])
        if self.fault == "altered_answer":
            out[0]["music_ids"] = out[0]["music_ids"][::-1]
        return out


def open_loop(batcher, pool, p, seconds, seed, results, stream):
    """Send the schedule's requests; returns (latencies s, failed, lateness
    s of the generator) once every reply is in or the drain has passed."""
    feats, masks = pool
    due = generate.arrivals(p, seconds, seed + stream)
    which = generate.rng(seed, 10, stream).integers(0, feats.shape[0], due.shape[0])
    lat = np.full(due.shape[0], np.nan)
    failed = np.zeros(due.shape[0], bool)
    late = np.zeros(due.shape[0])

    def client(i, t_due):
        try:
            reply = batcher.query(feats[which[i]][None].astype(np.float32),
                                  masks[which[i]][None], top_k=p["top_k"])
            lat[i] = time.perf_counter() - t_due
            results[(stream, i)] = (which[i], reply[0])
        except Exception:
            failed[i] = True

    pool_ex = ThreadPoolExecutor(max_workers=p["clients"])
    start = time.perf_counter()
    futures = []
    for i, t in enumerate(due):
        t_due = start + t
        wait = t_due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[i] = time.perf_counter() - t_due
        futures.append(pool_ex.submit(client, i, t_due))
    wait_for(futures, timeout=p["drain_seconds"])
    pool_ex.shutdown(wait=False, cancel_futures=True)
    return lat, failed, late, time.perf_counter() - start


class Serving:
    """The program set up for a serving cell: model, index, engine behind
    its timing proxy, micro-batcher, and the pool of request videos."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, fault=None):
        from mgsv_tpu_torch.models.made import MaDe
        from mgsv_tpu_torch.serve.engine import RetrievalEngine, build_music_index
        from mgsv_tpu_torch.serve.server import MicroBatcher

        p, flat = cell.traffic, cell.config
        self.cfg = port_config(flat, seed)
        self.weights = make_weights(flat, seed, device)
        with torch.device(device):
            self.model = MaDe(self.cfg, torch.Generator(device).manual_seed(0))
        self.model.to(device).load_state_dict(self.weights, strict=True)
        seg_feats, seg_mask = generate.catalog(p, flat, seed, device)
        self.seg_feats = seg_feats.cpu().numpy()
        self.seg_mask = seg_mask.cpu().numpy().astype(np.float32)
        del seg_feats
        self.ids = [f"t{i}" for i in range(p["tracks"])]
        self.index = build_music_index(self.model, self.ids, self.seg_feats, self.seg_mask,
                                       batch_size=p["index_batch"])
        self.engine = RetrievalEngine(self.model, self.cfg, self.index)
        self.engine.warmup(p["warm_buckets"], top_k=p["top_k"])
        self.proxy = TimedEngine(self.engine, fault)
        self.batcher = MicroBatcher(self.proxy, max_batch=p["max_batch"],
                                    max_wait_ms=p["max_wait_ms"])
        self.pool = generate.video_pool(p, flat, seed, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def run(cell: Cell, args, device: torch.device, t0: float, fault=None) -> Outcome:
    p, flat, seed = cell.traffic, cell.config, args.seed
    S = Serving(cell, seed, device, fault)
    cfg, batcher, proxy, pool, ids, index = S.cfg, S.batcher, S.proxy, S.pool, S.ids, S.index
    settle()
    setup_s = time.time() - t0

    results = {}
    d0 = batcher.dispatches
    lat, failed, late, window_s = open_loop(batcher, pool, p, args.seconds, seed, results, 0)
    dispatches = batcher.dispatches - d0
    query_s = proxy.seconds / max(len(proxy.batches), 1)
    done = lat[np.isfinite(lat)]
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    n_failed = int(failed.sum() + (~np.isfinite(lat) & ~failed).sum())
    print(f"portbench: {lat.shape[0]} requests due, {done.shape[0]} replied, "
          f"{dispatches} dispatches, generator late p50 {np.median(late) * 1e3:.3f} ms "
          f"max {late.max() * 1e3:.3f} ms, rejected {batcher.rejected}", flush=True)

    layer = None
    if args.trace:
        paths = counter_paths()
        before = {c: read_counter(c) for c in paths}
        n_batches, d1 = len(proxy.batches), batcher.dispatches
        got = {}
        with traced(got):
            open_loop(batcher, pool, p, p["trace_seconds"], seed, {}, 1)
        counters = {c: read_counter(c) - before[c] for c in paths}
        k_run = min(bucket(p["top_k"]), p["tracks"])
        traced_batches = proxy.batches[n_batches:]
        window_batches = proxy.batches[:n_batches]
        host = {"engine_query_s": query_s,
                "completed": int(done.shape[0]), "dispatches": dispatches, "units": dispatches,
                "window_s": window_s,
                "flops": sum(flops.serve_query_flops(flat, bucket(b), k_run, p["tracks"])
                             for b in window_batches)}
        layer = LayerContext(cell, host, got["summary"], counters, batcher.dispatches - d1,
                             detr_rows=[bucket(b) * k_run for b in traced_batches],
                             detr_precision="tf32", peak_flops=flops.PEAK_FLOPS[
                                 "bf16" if cfg.model.compute_dtype == "bfloat16" else "tf32"])

    # the sample: seeded, with the longest video among the replies
    keys = sorted(k for k in results if k[0] == 0)
    g = generate.rng(seed, 11)
    pick = list(g.choice(len(keys), size=min(p["sample"], len(keys)), replace=False))
    longest = max(range(len(keys)), key=lambda j: pool[1][results[keys[j]][0]].sum())
    if longest not in pick:
        pick[0] = longest
    sample = [results[keys[j]] for j in pick]
    row = {t: j for j, t in enumerate(ids)}
    served = {
        "ids": np.array([[row[t] for t in r["music_ids"]] for _, r in sample]),
        "scores": np.array([r["retrieval_scores"] for _, r in sample]),
        "moments": np.array([r["moments"] for _, r in sample]),
        "moment_scores": np.array([r["moment_scores"] for _, r in sample]),
    }
    tracks = np.unique(np.concatenate([served["ids"].ravel(),
                                       g.choice(p["tracks"], size=min(64, p["tracks"]))]))
    served["emb"] = index.music_embs[tracks]
    served["tok"] = index.seg_tokens[tracks]
    videos = np.array([v for v, _ in sample])
    weights, seg_feats, seg_mask = S.weights, S.seg_feats, S.seg_mask
    del S, batcher, proxy, index
    if device.type == "cuda":
        torch.cuda.empty_cache()

    with lowered("fp32"):
        ref = reference(weights, flat, seg_feats, seg_mask, pool, videos, served["ids"],
                        tracks, device)
    return Outcome(
        end_to_end={"serve_p50_ms": float(np.percentile(done, 50) * 1e3),
                    "serve_p95_ms": float(np.percentile(done, 95) * 1e3),
                    "setup_s": setup_s},
        checks=check.serve(served, ref), attempted=int(lat.shape[0]), failed=n_failed,
        memory_peak_bytes=memory_peak, layer=layer)


def reference(weights, flat, seg_feats, seg_mask, pool, videos, ids, tracks, device) -> dict:
    """The plain reference's index, scores and moments for the sample."""
    feats = torch.as_tensor(seg_feats, device=device)
    smask = torch.as_tensor(seg_mask, device=device)
    tok, emb = R.music_index(weights, flat, feats, smask)
    del feats
    frames = torch.as_tensor(pool[0][videos], device=device)
    fmask = torch.as_tensor(pool[1][videos], device=device)
    sims, ft, vemb = R.rank(weights, flat, frames, fmask, tok, emb, smask)
    k = ids.shape[1]
    cand = torch.as_tensor(ids.reshape(-1), device=device)
    rep = lambda t: t.repeat_interleave(k, dim=0)
    moments, scores = R.localize(weights, flat, rep(ft), rep(fmask), rep(vemb), tok[cand],
                                 smask[cand])
    tr = torch.as_tensor(tracks, device=device)
    return {"sims": check.numpy(sims), "moments": check.numpy(moments).reshape(-1, k, 2),
            "moment_scores": check.numpy(scores).reshape(-1, k),
            "emb": check.numpy(emb[tr]), "tok": check.numpy(tok[tr])}
