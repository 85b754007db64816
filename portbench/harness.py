"""The benchmark of the PyTorch/CUDA port, driven by data.

A cell (`workloads` in BENCHMARK.json) names a configuration and a traffic
mix.  The harness finds each by its name: the configuration in the file
the `configs` entry gives, the mix in `traffic/<name>.json`, whose
"driver" names the module under `drivers/` that runs it, the limits of the
output check in `limits/<cell>.json`, each per-layer metric's reader in
`metrics/<name>.py` and the kernel tables in `kernels/*.py`.  A new cell,
mix, metric or kernel is a new file and a new entry; no file here changes.

A run: set-up (data, weights and the program, warmed on the cell's
shapes), a window of `--seconds`, with `--trace 1` a short traced window
after it, then the check of what the timed path produced against the plain
reference.  The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import glob
import importlib
import importlib.util
import json
import math
import os
import re
import sys
from typing import Any, Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mgsv_tpu"}


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + re.sub(r"\W", "_", os.path.relpath(path, HERE)), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict           # flat "section.key" -> value, as run
    traffic: dict          # the mix's parameters
    limits: dict           # check name -> limit
    end_to_end: List[dict]
    per_layer: List[dict]


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, bench: dict, workload: str, here: str = HERE) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload, chips=w["chips"],
        config=load_json(os.path.join(root, conf["file"]))["config"],
        traffic=load_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        limits=load_json(os.path.join(here, "limits", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)])


# The serving cell that BENCHMARK.json does not hold yet (see PERF.md):
# its mix, configuration and limits are here, and a later benchmark PR
# adds it with an entry; the sweep, the control and the tests run it as is.
PENDING = {"serve-paper-idx16k": {"config": "made_paper", "traffic": "serve_open_idx16k"}}
SERVE_METRICS = [
    {"name": "serve_p50_ms", "unit": "ms", "better": "lower", "source": "host_clock"},
    {"name": "serve_p95_ms", "unit": "ms", "better": "lower", "source": "host_clock"}]


def with_pending(bench: dict, workload: str) -> dict:
    """`bench` with the pending cell `workload` and its latencies added,
    where BENCHMARK.json does not hold it."""
    if workload not in PENDING or workload in {w["name"] for w in bench["workloads"]}:
        return bench
    out = dict(bench, workloads=bench["workloads"] + [
        dict(PENDING[workload], name=workload, chips=1, why="pending")])
    out["end_to_end"] = bench["end_to_end"] + [dict(m, workloads=[workload])
                                               for m in SERVE_METRICS]
    return out


def port_config(flat: dict, seed: int):
    """The program's Config of a flat configuration, its seed the run's."""
    from mgsv_tpu_torch.config import Config
    flat = dict(flat)
    flat["train.seed"] = seed
    flat["train.mesh_shape"] = tuple(flat["train.mesh_shape"])
    return Config.from_overrides(flat)


class KernelTables:
    """The port's kernels (`kernels/*.py`): the device functions each
    launches, and the least time of its calls in a traced window."""

    def __init__(self):
        self.tables = [load_module(p) for p in sorted(glob.glob(os.path.join(HERE, "kernels",
                                                                            "*.py")))]
        names = "|".join(re.escape(n) for t in self.tables for n in t.NAMES)
        self._re = re.compile(rf"^(?:void )?\(anonymous namespace\)::(?:{names})[<(]")

    def is_port(self, kernel_name: str) -> bool:
        return bool(self._re.match(kernel_name))

    def least_s(self, ctx) -> float:
        return sum(t.least_s(ctx) for t in self.tables)


class LayerContext:
    """What the per-layer readers see: the traced window's summary, the
    host's measurements of the window, counters, shapes and peaks."""

    def __init__(self, cell: Cell, host: dict, trace, counters: Dict[str, int],
                 trace_units: int, batch: int = 0, detr_rows=(), detr_precision="tf32",
                 peak_flops: Optional[float] = None):
        from portbench.reference.made import dims
        self.cell, self.host, self.trace = cell, host, trace
        self.counters, self.trace_units = counters, trace_units
        self.batch, self.detr_rows, self.detr_precision = batch, list(detr_rows), detr_precision
        self.peak_flops = peak_flops
        self._dims = dims(cell.config)
        f, s, mult = self._dims["f"], self._dims["s"], cell.config["model.detr_seq_pad_multiple"]
        self._dims["detr_len"] = -(-(f + s) // mult) * mult
        tables = KernelTables()
        self.port_kernel_s = trace.kernel_s_matching(tables.is_port) if trace else 0.0
        self.kernel_least_s = tables.least_s(self) if trace else 0.0

    def dim(self, key: str) -> int:
        return self._dims[key]

    def launches(self, path: str) -> int:
        return self.counters.get(path, 0)


def read_counter(path: str) -> int:
    """A launch counter of the program, "module:function" -> its .launches."""
    mod, fn = path.split(":")
    return int(getattr(getattr(importlib.import_module(mod), fn), "launches", 0))


def counter_paths() -> List[str]:
    paths = []
    for t in KernelTables().tables:
        paths += [getattr(t, a) for a in ("FORWARD", "BACKWARD") if hasattr(t, a)]
    return paths


@dataclasses.dataclass
class Outcome:
    """What a driver hands back."""
    end_to_end: Dict[str, float]
    checks: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    layer: Optional[LayerContext] = None


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def settle() -> None:
    """Before a window: collect, and keep what set-up made out of later
    collections, so that the window's collections scan only its own
    objects."""
    gc.collect()
    gc.freeze()


def main(argv: List[str], t0: float, root: Optional[str] = None, require_cuda: bool = True,
         device: Optional[str] = None, fault: Optional[str] = None, here: str = HERE) -> int:
    """Run one cell; returns the exit code.  `require_cuda`, `device` and
    `fault` exist for the tests: a run on the CPU at a small configuration,
    and the timed path broken on purpose (drivers/*.py: FAULTS)."""
    args = parse(argv)
    root = root or os.path.dirname(here)
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = load_cell(root, bench, args.workload, here)
    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    out: Outcome = driver.run(cell, args, torch.device(device or "cuda:0"), t0, fault)

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}, which the port must not use", file=sys.stderr)
        return 3
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_module(os.path.join(here, "metrics", m["name"] + ".py")).read(out.layer)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in out.checks.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if require_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if require_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    result: Dict[str, Any] = {"correct": correct, "attempted": out.attempted,
                              "failed": out.failed, "metrics": metrics, "device": dev}
    if args.trace and out.layer is not None and out.layer.trace is not None:
        t = out.layer.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in t.top_kernels()],
                               "idle_gaps": [list(x) for x in t.idle_gaps()]}
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
