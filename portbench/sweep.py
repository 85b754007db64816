"""Find the serving knee once, by a sweep on the card: one process sets up a
serving cell as its run does, then runs its open loop at each rate in
turn and prints one JSON line a rate.

    python portbench/sweep.py --workload serve-paper-idx16k --seed 7 \
        --seconds 8 --rates 200,300,400,500,600,700

The knee is the highest rate at which the generator keeps its schedule,
nothing is refused or fails, and the queue does not grow over the window
(the last quarter's latencies no longer than twice the first quarter's).
The cell's traffic file then takes 4/5 of it as "rate_per_s".
"""

import argparse
import json
import os
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.drivers import serve  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", required=True)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.load_cell(ROOT, harness.with_pending(bench, a.workload), a.workload)
    s = serve.Serving(cell, a.seed, torch.device("cuda:0"))
    batcher, pool = s.batcher, s.pool
    print(json.dumps({"setup_s": time.time() - T0,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    for i, rate in enumerate(float(r) for r in a.rates.split(",")):
        p = dict(cell.traffic, rate_per_s=rate)
        d0, r0 = batcher.dispatches, batcher.rejected
        lat, failed, late, window = serve.open_loop(batcher, pool, p, a.seconds, a.seed, {}, i)
        ok = lat[np.isfinite(lat)]
        q = max(1, lat.shape[0] // 4)
        growth = float(np.nanmean(lat[-q:]) / np.nanmean(lat[:q]))
        print(json.dumps({
            "rate_per_s": rate, "due": int(lat.shape[0]), "replied": int(ok.shape[0]),
            "failed": int(failed.sum()), "rejected": batcher.rejected - r0,
            "dispatches": batcher.dispatches - d0,
            "rows_per_dispatch": ok.shape[0] / max(1, batcher.dispatches - d0),
            "p50_ms": float(np.percentile(ok, 50) * 1e3), "p95_ms": float(np.percentile(ok, 95) * 1e3),
            "late_max_ms": float(late.max() * 1e3), "late_p95_ms": float(np.percentile(late, 95) * 1e3),
            "growth": growth, "window_s": window}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
