"""HTTP/JSON serving front over the RetrievalEngine (numpy only; the port's
own copy of the JAX package's `mgsv_tpu/serve/server.py`).

Minimal stdlib RPC surface (no extra dependencies) exposing the production
capability the engine provides:

    GET  /healthz   -> {"status": "ok", "index_size": M, "model": ...}
    POST /query     -> body {"frame_feats": [[...frame vectors...] per video],
                             "frame_mask":  [[...0/1 per frame...]],
                             "top_k": 5}
                       reply: the engine's per-query result dicts
                       (ranked music_ids, retrieval_scores, moments in
                       seconds, moment_scores)

Concurrent requests are micro-batched: the device runs ONE query at a
time, so a coalescer thread drains whatever requests arrived while the
previous dispatch ran and sends them as one batch (a query at B=32 costs
far less than 32 queries at B=1, so coalescing multiplies throughput under
load instead of queueing it).  Request parsing/serialization happens
per-connection in the threaded HTTP server.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

logger = logging.getLogger("mgsv_tpu_torch")


class Overloaded(RuntimeError):
    """Admission rejected: the batcher's pending-row budget is exhausted.

    Raised synchronously by `query()` so clients shed load at the door
    (HTTP maps it to 429 + Retry-After) instead of parking on an
    ever-growing queue whose tail latency already exceeds any useful
    deadline."""


class RequestTooLarge(ValueError):
    """A single request exceeds the whole pending-row budget: retrying can
    NEVER succeed (admission requires pending + rows <= budget even on an
    idle server), so it must not ride the retryable 429 path — HTTP maps
    it to 413."""


class MicroBatcher:
    """Coalesces concurrent query() calls into single engine dispatches.

    A request enters the queue with a Future; the loop thread takes the
    first waiting request, then drains (up to `max_wait_ms` more) whatever
    else is queued up to `max_batch` rows, stacks the rows, runs ONE
    engine.query at the max requested top_k, and distributes the
    per-request slices.  Under no concurrency this adds one queue hop and
    at most `max_wait_ms` of latency; under load the batch fills while
    the previous dispatch runs."""

    def __init__(self, engine, max_batch: int = 32, max_wait_ms: float = 3.0,
                 result_timeout_s: float = 900.0, max_queue_rows: int = 1024):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        # generous: a cold batch bucket may pay a kernel build; the timeout
        # exists so a dead loop thread fails requests instead of hanging
        # them forever
        self.result_timeout_s = result_timeout_s
        # Admission control: rows admitted but not yet picked up by a
        # dispatch.  When requests arrive faster than the engine drains
        # them, an unbounded queue just converts overload into unbounded
        # memory + tail latency; past the budget we REJECT synchronously
        # (Overloaded -> HTTP 429) so callers back off.
        self.max_queue_rows = max_queue_rows
        self.dispatches = 0          # observability + tests
        self.rejected = 0
        self._pending_rows = 0
        self._admission = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def query(self, frame_feats: np.ndarray, frame_mask: np.ndarray,
              top_k: int):
        # Rank check BEFORE admission: the row accounting below and
        # _drain's shape[0] must agree on what a "row" is, and a garbage
        # payload must not be able to kill the loop thread (a dead loop
        # leaks _pending_rows and turns the server into permanent 429s).
        # Full shape validation stays per-item in _validate.
        frame_feats = np.asarray(frame_feats)
        if frame_feats.ndim != 3:
            raise ValueError(
                f"frame_feats must be [B, L, D], got rank {frame_feats.ndim}")
        rows = int(frame_feats.shape[0])
        if rows > self.max_queue_rows:
            # distinct from Overloaded: no amount of backoff makes a
            # request larger than the whole budget admissible
            raise RequestTooLarge(
                f"request has {rows} rows but the server's row budget is "
                f"{self.max_queue_rows}; split the request")
        with self._admission:
            if self._pending_rows + rows > self.max_queue_rows:
                self.rejected += 1
                raise Overloaded(
                    f"queue full: {self._pending_rows} rows pending "
                    f"(budget {self.max_queue_rows}); retry with backoff")
            self._pending_rows += rows
        fut: Future = Future()
        self._q.put((frame_feats, frame_mask, int(top_k), fut))
        return fut.result(timeout=self.result_timeout_s)

    def _drain(self):
        import time

        first = self._q.get()
        items, rows = [first], first[0].shape[0]
        deadline = time.monotonic() + self.max_wait_s
        while rows < self.max_batch:
            budget = deadline - time.monotonic()
            try:
                item = (self._q.get(timeout=budget) if budget > 0
                        else self._q.get_nowait())
            except queue.Empty:
                break
            items.append(item)
            rows += item[0].shape[0]
        with self._admission:
            self._pending_rows -= rows
        return items

    def _validate(self, it):
        """Shape-check one request against the engine's canonical input
        contract and normalize its frame count to max_v_frames (pad with
        mask-zero frames — semantically exact, masked frames are excluded
        from attention and the mean-pool; truncate beyond max_v_frames,
        the task's clip cap).  A canonical L means every dispatch runs the
        shapes the engine was warmed on."""
        ff, fm, k, fut = it
        cfg = self.engine.cfg.data
        if ff.ndim != 3 or ff.shape[2] != cfg.vit_dim:
            raise ValueError(
                f"frame_feats must be [B, L, {cfg.vit_dim}], got "
                f"{tuple(ff.shape)}")
        if fm.shape != ff.shape[:2]:
            raise ValueError(
                f"frame_mask {tuple(fm.shape)} does not match frame_feats "
                f"{tuple(ff.shape[:2])}")
        F = cfg.max_v_frames
        if ff.shape[1] > F:
            ff, fm = ff[:, :F], fm[:, :F]
        elif ff.shape[1] < F:
            pad = F - ff.shape[1]
            ff = np.pad(ff, ((0, 0), (0, pad), (0, 0)))
            fm = np.pad(fm, ((0, 0), (0, pad)))
        return ff, fm, k, fut

    def _loop(self):
        while True:
            items = self._drain()
            # per-request validation first: a malformed request fails ITS
            # future only, never the cohort it was coalesced with and
            # never the loop thread (which would hang every later request)
            good = []
            for it in items:
                try:
                    good.append(self._validate(it))
                except Exception as e:
                    it[-1].set_exception(e)
            if not good:
                continue
            try:
                feats = np.concatenate([it[0] for it in good])
                masks = np.concatenate([it[1] for it in good])
                k_max = max(it[2] for it in good)
                results = self.engine.query(feats, masks, top_k=k_max)
                self.dispatches += 1
                off = 0
                for ff, _, k, fut in good:
                    rows = results[off:off + ff.shape[0]]
                    fut.set_result([
                        {key: (v[:k] if isinstance(v, list) else v)
                         for key, v in r.items()} for r in rows])
                    off += ff.shape[0]
            except Exception as e:
                for *_, fut in good:
                    if not fut.done():
                        fut.set_exception(e)


def make_handler(engine, model_name: str, **batcher_kwargs):
    batcher = MicroBatcher(engine, **batcher_kwargs)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            logger.debug("serve: " + fmt, *args)

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            self._reply(200, {
                "status": "ok",
                "index_size": len(engine.index.music_ids),
                "model": model_name,
                "dispatches": batcher.dispatches,
                "rejected": batcher.rejected,
            })

        def do_POST(self):
            if self.path != "/query":
                return self._reply(404, {"error": "unknown path"})
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                frame_feats = np.asarray(req["frame_feats"], np.float32)
                if frame_feats.ndim == 2:      # single video convenience
                    frame_feats = frame_feats[None]
                frame_mask = np.asarray(
                    req.get("frame_mask",
                            np.ones(frame_feats.shape[:2])), np.float32)
                if frame_mask.ndim == 1:
                    frame_mask = frame_mask[None]
                top_k = int(req.get("top_k", 5))
                top_k = max(1, min(top_k, len(engine.index.music_ids)))
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                return self._reply(400, {"error": f"bad request: {e}"})
            try:
                results = batcher.query(frame_feats, frame_mask, top_k=top_k)
            except RequestTooLarge as e:   # unsatisfiable, not retryable
                return self._reply(413, {"error": str(e)})
            except Overloaded as e:   # shed load at admission, not silently
                self.send_response(429)
                body = json.dumps({"error": str(e)}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(body)
                return
            except ValueError as e:  # malformed payload (e.g. wrong rank)
                return self._reply(400, {"error": f"bad request: {e}"})
            except Exception as e:  # surface engine errors as 500s
                logger.exception("query failed")
                return self._reply(500, {"error": str(e)})
            self._reply(200, {"results": results})

    Handler.batcher = batcher       # expose for tests/observability
    return Handler


class RetrievalServer:
    """Threaded HTTP server wrapper; `serve_forever` blocks, `start`
    runs it on a daemon thread (tests/embedding)."""

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 8008,
                 model_name: str = "made", **batcher_kwargs):
        self.httpd = ThreadingHTTPServer(
            (host, port), make_handler(engine, model_name, **batcher_kwargs))
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "RetrievalServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        logger.info("serving on :%d", self.port)
        return self

    def serve_forever(self):
        logger.info("serving on :%d", self.port)
        self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
