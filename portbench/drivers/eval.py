"""Whole evaluations back to back on a device-resident split, as the
Trainer runs one after every epoch.

Set-up makes the split's tables on the device in
data/device_data.py::gather_batch's layout (generate.eval_tables) and
hands them to the program as its DeviceResidentData, makes the weights
from the seed, builds the program's model and
train/step.py::make_eval_step's step, and runs `warm_passes` evaluations,
in which the kernels build (with `--trace 0` the last under the device
clock, whose first start loads the profiler).  The window: calls of
eval/evaluator.py::evaluate as Trainer.eval_epoch makes them (the model,
the resident split, the Config, the eval step) until `--seconds` have
passed on the host clock; each returns host arrays, so each ends on the
host, and the window closes with a synchronize.  With `--trace 0` every
pass of the window runs under trace.DeviceClock, and `eval_device_s` is
the device's busy seconds over the window's passes; with `--trace 1` the
window runs bare, its host seconds a pass are `eval.epoch_s.eval`, and
`trace_passes` more evaluations run under the profiler.  Once the window
has closed and the memory peak is read, the program is freed and the plain
reference (reference/made.py::evaluation) evaluates the same rows with the
same weights; the check compares the window's last pass with it: its
similarity and spans, which evaluate returns, and each batch's retrieval
loss, which the benchmark keeps from the eval step's outputs as they pass.
"""

from __future__ import annotations

import contextlib
import math
import time
from unittest import mock

import torch

from portbench import check, flops, generate
from portbench.harness import (Cell, LayerContext, Outcome, counter_paths,
                               port_config, read_counter, settle)
from portbench.reference import made as R
from portbench.reference.precision import lowered
from portbench.trace import DeviceClock, traced
from portbench.weights import make_weights

FAULTS = ("dual_only", "half_rows")


def resident(tree: dict):
    """The program's DeviceResidentData over the benchmark's tables (its
    constructor uploads a host dataset; these are made on the device)."""
    from mgsv_tpu_torch.data.csv_index import CsvIndex
    from mgsv_tpu_torch.data.device_data import DeviceResidentData

    host = {k: tree[k].cpu().numpy() for k in ("music_rows", "vdur", "mdur", "gt", "spans")}
    n = host["music_rows"].shape[0]
    data = DeviceResidentData.__new__(DeviceResidentData)
    data.mesh, data.tree, data.device = None, tree, tree["vf"].device
    data.index = CsvIndex([f"v{i}" for i in range(n)], [f"m{t}" for t in host["music_rows"]],
                          host["vdur"], host["mdur"], host["gt"], host["spans"])
    return data


@contextlib.contextmanager
def planted(fault, data):
    """The timed path broken underneath: `dual_only` drops the X-Pool term
    of the corpus similarity; `half_rows` evaluates the second half of the
    rows from the first half's."""
    from mgsv_tpu_torch.data.device_data import gather_batch
    from mgsv_tpu_torch.eval import evaluator

    with contextlib.ExitStack() as stack:
        if fault == "dual_only":
            def zeros(*args, **kwargs):     # [V, M] of the videos [V, D], tokens [M, S, D]
                video, tokens = [a for a in args if isinstance(a, torch.Tensor)][:2]
                return video.new_zeros(video.shape[0], tokens.shape[0])

            for name in ("xpool_sim_fused", "xpool_similarity_blocked"):
                stack.enter_context(mock.patch.object(evaluator, name, zeros))
        elif fault == "half_rows":
            half = len(data) // 2
            data.batch = lambda idx: gather_batch(data.tree, torch.where(idx >= half,
                                                                         idx - half, idx))
        yield


def run(cell: Cell, args, device: torch.device, t0: float, fault=None) -> Outcome:
    from mgsv_tpu_torch.eval.evaluator import evaluate
    from mgsv_tpu_torch.models.made import MaDe
    from mgsv_tpu_torch.train.step import make_eval_step

    p, flat, seed = cell.traffic, cell.config, args.seed
    cfg = port_config(flat, seed)
    batch_size = cfg.train.batch_size_val
    tree = generate.eval_tables(p, flat, seed, device)
    data = resident(tree)
    weights = make_weights(flat, seed, device)
    with torch.device(device):
        model = MaDe(cfg, torch.Generator(device).manual_seed(0))
    model.to(device).load_state_dict(weights, strict=True)
    program_step = make_eval_step(model, cfg)
    retrieval = []          # the current pass's retrieval loss a batch, on the device

    def eval_step(batch):
        out = program_step(batch)
        retrieval.append(out["retrieval_loss"])
        return out

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)

    with planted(fault, data):
        def one_pass():
            retrieval.clear()
            return evaluate(model, data, cfg, eval_step=eval_step)

        for i in range(p["warm_passes"]):
            last = not args.trace and i == p["warm_passes"] - 1
            with DeviceClock(device)() if last else contextlib.nullcontext():
                one_pass()
        settle()
        sync()
        setup_s = time.time() - t0

        # the window; with --trace 0 each pass under the device clock
        clock = DeviceClock(device)
        passes, failed, res = 0, 0, None
        start = time.perf_counter()
        while time.perf_counter() - start < args.seconds:
            with clock() if not args.trace else contextlib.nullcontext():
                res = one_pass()
            passes += 1
            failed += not math.isfinite(res["loss"])
        sync()
        window_s = time.perf_counter() - start
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        got = {"sim": check.numpy(res["sim"]), "spans": res["pred_spans"], "loss": res["loss"],
               "retrieval_losses": check.numpy(torch.stack(retrieval))}
        del res

        layer = None
        if args.trace:
            paths = counter_paths()
            before = {c: read_counter(c) for c in paths}
            summary = {}
            with traced(summary):
                for _ in range(p["trace_passes"]):
                    one_pass()
            counters = {c: read_counter(c) - before[c] for c in paths}
            batches = -(-p["rows"] // batch_size)
            prec = "bf16" if cfg.model.compute_dtype == "bfloat16" else "tf32"
            host = {"window_s": window_s, "units": passes,
                    "flops": flops.eval_pass_flops(flat, p["rows"], batch_size)["pass"] * passes}
            layer = LayerContext(cell, host, summary["summary"], counters, p["trace_passes"],
                                 batch=batch_size,
                                 detr_rows=[batch_size] * (batches * p["trace_passes"]),
                                 detr_precision=prec, peak_flops=flops.PEAK_FLOPS[prec])

    # free the program, then the reference on the same rows and weights
    del model, eval_step, program_step, data, retrieval
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with lowered("fp32"):
        ref = R.evaluation(weights, flat, tree, batch_size)
    ref = dict(ref, sim=check.numpy(ref["sim"]), spans=check.numpy(ref["spans"]))
    print(f"portbench: {passes} evaluations of {p['rows']} rows, eval loss {got['loss']!r} "
          f"reference {ref['loss']!r}", flush=True)
    return Outcome(
        end_to_end={"eval_device_s": clock.busy_s / passes, "setup_s": setup_s},
        checks=check.evaluation(got, ref), attempted=passes, failed=failed,
        memory_peak_bytes=memory_peak, layer=layer)
